// Lateral first-crossing plane march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lif_tpu/ops/pallas/sweep_march.py::_kernel
// (launched by _sweep_lateral). For every pose p and output pixel (i, j)
// it walks the pose's snap planes near -> far over the x-shifted source
// disparity, finds the FIRST plane k whose warped inverse depth lies in
// front of the plane (diff > 0), and returns the secant-refined crossing
// invz* and the color lerped between the warps at planes k-1 and k —
// the outputs found / invz* / rgba* of the plain twin
// lif_tpu_torch.ops.sweep_march.render_translation_plain, bit for bit.
//
// Design. One thread marches one (pose, row, column) pixel; a warp covers
// 32 adjacent columns of one row, so each plane's shifted read of the
// row-major source is one coalesced load of 33 floats. The first-crossing
// search and the color lerp fuse: on its first crossing a thread reads
// the color at planes k-1 and k, lerps, writes and stops. Column clamping
// replaces the edge padding of the TPU layout (the transposed (C, W, H)
// stack, the 8-aligned slices and their 16-way switch, the 128-lane
// height pad and the flattened SMEM tables are all TPU constraints and
// are gone). A block is tw columns x (128 / tw) rows and lies inside one
// (tw-column band x 128-row chunk) cell, so it reads that cell's plane
// range [k_lo, k_hi) from the bounds tables (lif_tpu_torch/ops/bounds.py),
// and seeds the secant bracket by warping plane k_lo - 1 first (the TPU
// kernel's bracket refresh).
//
// Bound on the H100: source re-reads. Each visited plane costs every
// thread two 4-byte disparity reads — up to (k_hi - k_lo) x 8 B per pixel
// from L1/L2 against one 24-byte output write — while the row window of a
// block (a few KB) stays cache-resident across planes, so device memory
// sees little more than one source read per block and the output. The
// work is a serial loop of dependent cache loads per thread; the bounded
// plane range and the early exit at the first crossing are what cut it.
// The per-plane cm3/occ2 skip tests are left to a later change.
// FP32 ops: per plane 8, per pixel 0, per found 52.
// (Per visited plane the lerp, the decode and the crossing test; at
// the crossing the secant and nine lerps.)
//
// Arithmetic: every float operation of the crossing test, the secant and
// the lerps is an explicitly rounded intrinsic (and the library is built
// with --fmad=false), in the order the plain twin evaluates it, so a
// contracted multiply-add cannot flip a tie of diff > 0.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // a * (1 - f) + b * f
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ float mix_rn(float lo, float hi, float s) {
  // lo + s * (hi - lo)
  return __fadd_rn(lo, __fmul_rn(s, __fsub_rn(hi, lo)));
}

__global__ void lateral_march_kernel(
    const float* __restrict__ src,   // (5, H, W): r, g, b, mask, disp
    const int* __restrict__ ix,      // (B, K) window starts, padded coords
    const float* __restrict__ fx,    // (B, K) lerp fractions
    const float* __restrict__ izt,   // (B, K) plane invz, near -> far
    const int* __restrict__ klo,     // (B, nb, n_hc) first plane to visit
    const int* __restrict__ khi,     // (B, nb, n_hc) one past the last
    float* __restrict__ found,       // (B, H, out_w)
    float* __restrict__ invz_star,   // (B, H, out_w)
    float4* __restrict__ rgba_star,  // (B, H, out_w)
    int K, int H, int W, int out_w, int pad_lo_x, int n_hc,
    float izmin, float izmax) {
  const int band = blockIdx.x;
  const int j = band * blockDim.x + threadIdx.x;  // output column
  const int i = blockIdx.y * blockDim.y + threadIdx.y;  // row
  const int p = blockIdx.z;  // pose
  if (i >= H) return;

  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(i) * W;
  const float* disp = src + 4 * plane + row;
  const int* ixp = ix + static_cast<size_t>(p) * K;
  const float* fxp = fx + static_cast<size_t>(p) * K;
  const float* izp = izt + static_cast<size_t>(p) * K;
  const int cell = (p * gridDim.x + band) * n_hc + i / 128;
  const int k0 = klo[cell];
  const int k1 = khi[cell];
  const float dsc = __fsub_rn(izmin, izmax);
  const int x0 = j - pad_lo_x;  // source column of window start 0

  auto tap = [&](int k, int d) {
    return min(max(x0 + ixp[k] + d, 0), W - 1);
  };
  // decoded inverse depth of the warped disparity minus the plane's
  auto diff_at = [&](int k) {
    const float tex = lerp_rn(disp[tap(k, 0)], disp[tap(k, 1)], fxp[k]);
    return __fsub_rn(__fadd_rn(__fmul_rn(tex, dsc), izmax), izp[k]);
  };

  float pd = k0 > 0 ? diff_at(k0 - 1) : 0.0f;
  float f_out = 0.0f, iz_out = 0.0f;
  float4 c_out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = k0; k < k1; ++k) {
    const float d = diff_at(k);
    if (d > 0.0f) {
      float s = 1.0f;  // a first-plane crossing snaps to plane 0
      float prev[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (k > 0) {
        const float t = __fdiv_rn(pd, fminf(__fsub_rn(pd, d), -1e-12f));
        s = fminf(fmaxf(t, 0.0f), 1.0f);
        const int a = tap(k - 1, 0), b = tap(k - 1, 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float* ch = src + c * plane + row;
          prev[c] = lerp_rn(ch[a], ch[b], fxp[k - 1]);
        }
      }
      const int a = tap(k, 0), b = tap(k, 1);
      float cur[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float* ch = src + c * plane + row;
        cur[c] = lerp_rn(ch[a], ch[b], fxp[k]);
      }
      c_out = make_float4(mix_rn(prev[0], cur[0], s), mix_rn(prev[1], cur[1], s),
                          mix_rn(prev[2], cur[2], s), mix_rn(prev[3], cur[3], s));
      iz_out = mix_rn(izp[k > 0 ? k - 1 : 0], izp[k], s);
      f_out = 1.0f;
      break;
    }
    pd = d;
  }
  const size_t o = (static_cast<size_t>(p) * H + i) * out_w + j;
  found[o] = f_out;
  invz_star[o] = iz_out;
  rgba_star[o] = c_out;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// tw (the band width, dividing out_w and 128) sets the block shape.
extern "C" int lif_lateral_march(
    const void* src, const void* ix, const void* fx, const void* izt,
    const void* klo, const void* khi, void* found, void* invz_star,
    void* rgba_star, int B, int K, int H, int W, int out_w, int pad_lo_x,
    int tw, int n_hc, float izmin, float izmax, void* stream) {
  const dim3 block(tw, 128 / tw);
  const dim3 grid(out_w / tw, (H + block.y - 1) / block.y, B);
  lateral_march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(ix),
      static_cast<const float*>(fx), static_cast<const float*>(izt),
      static_cast<const int*>(klo), static_cast<const int*>(khi),
      static_cast<float*>(found), static_cast<float*>(invz_star),
      static_cast<float4*>(rgba_star), K, H, W, out_w, pad_lo_x, n_hc,
      izmin, izmax);
  return static_cast<int>(cudaGetLastError());
}
