// Target-ray first-crossing march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lif_tpu/ops/pallas/sweep_target.py::_kernel
// (launched by _sweep_target). For every pose p and output pixel (i, j)
// the source position of the target ray at inverse depth v is affine in v
// with per-pixel coefficients from the pose's homography,
//     X = AX(i, j) + v * DX(i, j),   Y = AY(i, j) + v * DY(i, j),
// and the kernel walks the pose's plane ladder near -> far, reading the
// source disparity bilinearly at (X, Y), and stops at the FIRST plane
// whose texel lies in front of the plane threshold (diff > 0). It returns
// found, the secant-refined crossing invz* (with `refine` in-bracket
// sub-planes) and, in full-color mode, the bracket lerp of the
// [r, g, b, mask] samples at planes k*-1 and k* — the outputs of the
// plain twin lif_tpu_torch.ops.sweep_target.march_target_plain.
//
// Design. One thread marches one (pose, row, column) pixel; a block is
// 32 columns x 8 rows of one pose, so a warp reads 32 neighbouring
// positions of one source row band per plane. The pose's ladder and
// thresholds (K <= 1024) are staged in shared memory. The TPU layout (the
// transposed stack, 16-band groups, hat-candidate classes, DMA windows,
// lane rolls, the cm3/occ2 skip tables, flattened SMEM tables) is not
// carried over: the source stays row-major and the disparity (4 MB at
// 1280x800) stays resident in L2 across the pose batch. The one skip
// kept is exact: ladder planes whose threshold exceeds every texel (the
// bucketed ladder's padding above izmin) cannot host a crossing, so a
// block starts at the plane before the first one that can.
//
// Bound on the H100: a serial loop of dependent cache loads per thread,
// four 4-byte bilinear taps per plane until the crossing, against a
// 8-byte (depth) or 24-byte (color) output write per pixel.
// FP32 ops: per plane 31, per pixel 32, per found 8.
// (Per visited plane the affine position, the bilinear tap weights and
// sum, and the test; per pixel the four affine fields; at the crossing
// the secant.)
//
// Arithmetic: every float operation is an explicitly rounded intrinsic,
// in the twin's order (and the library is built with --fmad=false);
// divisions are true divisions, so the crossing test cannot flip at a
// tie against the twin.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 1024;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// lif_tpu's _bil: tap origin clamped to [0, w-2] x [0, h-2], fractions to
// [0, 1], summed as ((g00*(1-fx))*(1-fy) + (g01*fx)*(1-fy)) + ... .
__device__ __forceinline__ float bil(const float* __restrict__ img, int h,
                                     int w, float px, float py) {
  const float x0f = fminf(fmaxf(floorf(px), 0.0f), static_cast<float>(w - 2));
  const float y0f = fminf(fmaxf(floorf(py), 0.0f), static_cast<float>(h - 2));
  const float fx = clamp01(__fsub_rn(px, x0f));
  const float fy = clamp01(__fsub_rn(py, y0f));
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  const float* r0 = img + static_cast<size_t>(y0f) * w + static_cast<int>(x0f);
  const float* r1 = r0 + w;
  float s = __fmul_rn(__fmul_rn(__ldg(r0), gx), gy);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(r0 + 1), fx), gy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(r1), gx), fy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__ldg(r1 + 1), fx), fy));
  return s;
}

// pd / min(pd - d, -1e-12), clipped to [0, 1]
__device__ __forceinline__ float secant(float pd, float d) {
  return clamp01(__fdiv_rn(pd, fminf(__fsub_rn(pd, d), -1e-12f)));
}

__device__ __forceinline__ float mix_rn(float lo, float hi, float t) {
  // lo + t * (hi - lo)
  return __fadd_rn(lo, __fmul_rn(t, __fsub_rn(hi, lo)));
}

template <bool kColor>
__global__ void __launch_bounds__(kBlockX * kBlockY)
target_march_kernel(
    const float* __restrict__ disp,  // (src_h, src_w)
    const float* __restrict__ rgbm,  // (4, src_h, src_w), color mode only
    const float* __restrict__ pose,  // (B, 16): p_ts row-major, c_vec
    const float* __restrict__ vg,    // (B, K) plane invz, descending
    const float* __restrict__ tk,    // (B, K) texel thresholds
    const float* __restrict__ dmax,  // (1,) max disparity texel
    float* __restrict__ found,       // (B, out_h, out_w)
    float* __restrict__ invz_star,   // (B, out_h, out_w)
    float4* __restrict__ rgba_star,  // (B, out_h, out_w), color mode only
    int K, int src_h, int src_w, int out_h, int out_w, int refine) {
  __shared__ float s_v[kMaxPlanes];
  __shared__ float s_t[kMaxPlanes];
  __shared__ int s_k0;
  const int p = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (tid == 0) s_k0 = K;
  for (int k = tid; k < K; k += nthreads) {
    s_v[k] = vg[static_cast<size_t>(p) * K + k];
    s_t[k] = tk[static_cast<size_t>(p) * K + k];
  }
  __syncthreads();
  // every bilinear read is <= max(disp) up to a few roundings, so a plane
  // whose threshold is above this bound cannot cross (NaN never skips)
  const float m = __ldg(dmax);
  const float bound = m + fabsf(m) * 1.52587890625e-05f + 1e-30f;
  for (int k = tid; k < K; k += nthreads) {
    if (!(s_t[k] > bound)) atomicMin(&s_k0, k);
  }
  __syncthreads();
  const int k_start = max(s_k0 - 1, 0);

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= out_h || j >= out_w) return;

  // per-pixel fields, in the order of the twin's _fields
  const float* ps = pose + static_cast<size_t>(p) * 16;
  const float p00 = ps[0], p01 = ps[1], p02 = ps[2];
  const float p10 = ps[3], p11 = ps[4], p12 = ps[5];
  const float p20 = ps[6], p21 = ps[7], p22 = ps[8];
  const float cv0 = ps[9], cv1 = ps[10], cv2 = ps[11];
  const float sx = __fsub_rn(
      __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f),
                static_cast<float>(out_w)), 0.5f);
  const float sy = __fsub_rn(
      __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                static_cast<float>(out_h)), 0.5f);
  const float den =
      __fadd_rn(__fadd_rn(__fmul_rn(p20, sx), __fmul_rn(p21, sy)), p22);
  const float qx = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p00, sx), __fmul_rn(p01, sy)), p02), den);
  const float qy = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p10, sx), __fmul_rn(p11, sy)), p12), den);
  const float fw = static_cast<float>(src_w), fh = static_cast<float>(src_h);
  const float ax = __fsub_rn(__fmul_rn(__fadd_rn(qx, 0.5f), fw), 0.5f);
  const float ay = __fsub_rn(__fmul_rn(__fadd_rn(qy, 0.5f), fh), 0.5f);
  const float dx = __fmul_rn(__fsub_rn(cv0, __fmul_rn(cv2, qx)), fw);
  const float dy = __fmul_rn(__fsub_rn(cv1, __fmul_rn(cv2, qy)), fh);
  auto tex_at = [&](float v) {
    return bil(disp, src_h, src_w, __fadd_rn(ax, __fmul_rn(v, dx)),
               __fadd_rn(ay, __fmul_rn(v, dy)));
  };

  // pass 1: the first crossing and its bracket
  int ks = -1;
  float pd = 0.0f, pdc = 0.0f, dc = 0.0f;
  for (int k = k_start; k < K; ++k) {
    const float d = __fsub_rn(tex_at(s_v[k]), s_t[k]);
    if (d > 0.0f) {
      ks = k;
      pdc = pd;
      dc = d;
      break;
    }
    pd = d;
  }
  float t = ks == 0 ? 1.0f : secant(pdc, dc);
  const int km1 = max(ks - 1, 0), kc = max(ks, 0);
  const float v0 = s_v[km1], v1 = s_v[kc];
  if (refine > 0 && ks >= 0) {
    // in-bracket sub-sweep at exactly lerped invz and thresholds
    const float th0 = s_t[km1], th1 = s_t[kc];
    const double step = 1.0 / static_cast<double>(refine + 1);
    float slo = 0.0f, pd2 = pdc, d2 = dc, prev_g = pdc, prev_s = 0.0f;
    bool sfound = false;
    for (int jj = 1; jj <= refine; ++jj) {
      const float s = static_cast<float>(static_cast<double>(jj) * step);
      const float g = __fsub_rn(tex_at(mix_rn(v0, v1, s)), mix_rn(th0, th1, s));
      if (!sfound && g > 0.0f) {
        slo = prev_s;
        pd2 = prev_g;
        d2 = g;
        sfound = true;
      }
      prev_g = g;
      prev_s = s;
    }
    if (!sfound) {
      slo = prev_s;
      pd2 = prev_g;
    }
    t = ks == 0 ? 1.0f
                : __fadd_rn(slo, __fmul_rn(static_cast<float>(step),
                                           secant(pd2, d2)));
  }
  const size_t o = (static_cast<size_t>(p) * out_h + i) * out_w + j;
  found[o] = ks >= 0 ? 1.0f : 0.0f;
  invz_star[o] = ks >= 0 ? mix_rn(v0, v1, t) : 0.0f;
  if constexpr (kColor) {
    // the [r, g, b, mask] samples at the bracketing planes (plane 0 for
    // a pixel with no crossing), lerped at t; k* == 0 takes plane 0
    const float px0 = __fadd_rn(ax, __fmul_rn(v0, dx));
    const float py0 = __fadd_rn(ay, __fmul_rn(v0, dy));
    const float px1 = __fadd_rn(ax, __fmul_rn(v1, dx));
    const float py1 = __fadd_rn(ay, __fmul_rn(v1, dy));
    const size_t plane = static_cast<size_t>(src_h) * src_w;
    float c[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const float* img = rgbm + ch * plane;
      const float c0 = bil(img, src_h, src_w, px0, py0);
      const float c1 = bil(img, src_h, src_w, px1, py1);
      c[ch] = ks == 0 ? c1 : mix_rn(c0, c1, t);
    }
    rgba_star[o] = make_float4(c[0], c[1], c[2], c[3]);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for a ladder longer than kMaxPlanes. rgbm and
// rgba_star are both null (depth only) or both set (full color).
extern "C" int lif_target_march(
    const void* disp, const void* rgbm, const void* pose, const void* vg,
    const void* tk, const void* dmax, void* found, void* invz_star,
    void* rgba_star, int B, int K, int src_h, int src_w, int out_h,
    int out_w, int refine, void* stream) {
  if (K < 1 || K > kMaxPlanes || src_w < 2 || src_h < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((out_w + kBlockX - 1) / kBlockX,
                  (out_h + kBlockY - 1) / kBlockY, B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rgbm != nullptr) {
    target_march_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), static_cast<const float*>(rgbm),
        static_cast<const float*>(pose), static_cast<const float*>(vg),
        static_cast<const float*>(tk), static_cast<const float*>(dmax),
        static_cast<float*>(found), static_cast<float*>(invz_star),
        static_cast<float4*>(rgba_star), K, src_h, src_w, out_h, out_w,
        refine);
  } else {
    target_march_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), nullptr,
        static_cast<const float*>(pose), static_cast<const float*>(vg),
        static_cast<const float*>(tk), static_cast<const float*>(dmax),
        static_cast<float*>(found), static_cast<float*>(invz_star), nullptr,
        K, src_h, src_w, out_h, out_w, refine);
  }
  return static_cast<int>(cudaGetLastError());
}
