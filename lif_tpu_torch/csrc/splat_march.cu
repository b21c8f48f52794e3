// Billboard splat of a lateral pose batch for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lif_tpu/ops/pallas/splat_march.py:99 `_kernel`
// (launched by render_billboard_batch_pallas). On a lateral pose the
// z-buffered billboard scatter (ops/splat.py::forward_splat) has an exact
// gather dual: target pixel (i, o) can only be covered by source pixel
// s = o - m of its own row for an integer shift m of the pose's ladder,
// and it is covered iff
//     0 <= s <= W-1  and  (m - delta)^2 <= su_half^2,
//     delta = A * t + Bc,  t = disp[i, s],
//     su_half = max(half_ps * sqrt(xterm + yterm + 1), 0.5),
//     xterm = ((s + 0.5 - cx0) * inv_f)^2,  yterm = ((i + 0.5 - cy0) * inv_f)^2.
// Walking the ladder near -> far, the first covered plane wins; then the
// chain of upgrades runs: while the winner sits at plane k-1 and plane k
// is covered with t_k > t_best (or t_k == t_best and the smaller window
// start, i.e. the lower source id), plane k takes over; the chain stops at
// the first plane that does not upgrade. Outputs: found, the winner's
// disparity texel (-1 where none) and its [r, g, b, mask] point texel (0
// where none) — what the plain twin
// lif_tpu_torch.ops.splat_march.billboard_march_plain returns.
//
// Design. One thread per (pose, row, output column); a block is 32 columns
// x 8 rows of one pose, so a warp's per-plane read of disp[i, o - m] is one
// coalesced row segment. The pose's ladder (window starts and shifts,
// K <= 1024) is staged in shared memory. A thread stops at the end of its
// chain and then reads the winner's colour once as a float4 from the
// (H, W, 4) [r, g, b, mask] stack. The TPU kernel's extra parts (the
// cm3/occ2 skip tests, the nfound/crossflag early exit, the transposed
// 8-aligned resident window and its two passes) only save work on the TPU
// or follow Mosaic's layout; they change no output and are not carried
// over.
//
// Bound on the H100: bytes. The function is a z-buffered 2 x 2 splat: per
// pose and source pixel it reads 4 (disp) + 16 (colour) bytes once and per
// target pixel writes 24, and its float work is O(1) per source pixel:
// FP32 ops: per plane 0, per pixel 32, per found 0.
// (delta 2; su_half 13: x and y offsets 3 + 3, their squares 2, two adds,
// sqrt, scale, max; su^2 1; and for each of at most 4 footprint pixels a
// cover test — subtract, square, compare — and a depth compare, 16.) This
// kernel does more than that: a pixel that is not covered early walks most
// of the ladder, a serial loop of ~17 float operations and one
// L1/L2-resident load per plane (its winner's ladder position + 2 planes,
// all K where nothing covers it). The walk is this algorithm's cost, not
// the function's; the redesign that removes it, an atomic-min scatter of
// packed (depth, source id), is a later change.
//
// Arithmetic: every float operation is an explicitly rounded intrinsic in
// the twin's order (the library is built with --fmad=false), inv_f is the
// host-rounded float32 1/f1 and half_ps the float32 0.5 * point_size, so
// the kernel and its twin agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 1024;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
billboard_kernel(
    const float* __restrict__ disp,   // (H, W)
    const float4* __restrict__ rgbm,  // (H, W): r, g, b, mask
    const int* __restrict__ ixs,      // (B, K) window starts, padded coords
    const float* __restrict__ mms,    // (B, K) integer shifts m
    const float* __restrict__ abp,    // (B, 3): A, Bc, su_half_max
    float* __restrict__ found,        // (B, H, W)
    float* __restrict__ tex,          // (B, H, W)
    float4* __restrict__ rgba,        // (B, H, W)
    int K, int H, int W, int pad_lo_x, float cx0, float cy0, float inv_f,
    float half_ps) {
  __shared__ int s_ix[kMaxPlanes];
  __shared__ float s_m[kMaxPlanes];
  const int p = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int k = tid; k < K; k += blockDim.x * blockDim.y) {
    s_ix[k] = ixs[static_cast<size_t>(p) * K + k];
    s_m[k] = mms[static_cast<size_t>(p) * K + k];
  }
  __syncthreads();

  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || o >= W) return;
  const float A = __ldg(abp + 3 * p);
  const float Bc = __ldg(abp + 3 * p + 1);
  const float yv =
      __fmul_rn(__fsub_rn(__fadd_rn(static_cast<float>(i), 0.5f), cy0), inv_f);
  const float yterm = __fmul_rn(yv, yv);
  const float* row = disp + static_cast<size_t>(i) * W;
  const int base = o - pad_lo_x;  // source column of window start 0

  int kstar = -1;
  float btex = -1.0f;
  for (int k = 0; k < K; ++k) {
    const int s = base + s_ix[k];
    bool covered = false;
    float t = 0.0f;
    if (s >= 0 && s <= W - 1) {
      t = __ldg(row + s);
      const float delta = __fadd_rn(__fmul_rn(A, t), Bc);
      const float xv = __fmul_rn(
          __fsub_rn(__fadd_rn(static_cast<float>(s), 0.5f), cx0), inv_f);
      const float su = fmaxf(
          __fmul_rn(half_ps,
                    __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(xv, xv), yterm),
                                         1.0f))),
          0.5f);
      const float d = __fsub_rn(s_m[k], delta);
      covered = __fmul_rn(d, d) <= __fmul_rn(su, su);
    }
    if (kstar < 0) {
      if (covered) {
        kstar = k;
        btex = t;
      }
    } else if (covered &&
               (t > btex || (t == btex && s_ix[k] < s_ix[k - 1]))) {
      kstar = k;  // the winner at k-1 is beaten: the chain goes on
      btex = t;
    } else {
      break;  // the chain stops; no later plane can change this pixel
    }
  }
  const size_t out = (static_cast<size_t>(p) * H + i) * W + o;
  found[out] = kstar >= 0 ? 1.0f : 0.0f;
  tex[out] = btex;
  rgba[out] = kstar >= 0
                  ? __ldg(rgbm + static_cast<size_t>(i) * W + base + s_ix[kstar])
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for a ladder longer than kMaxPlanes.
extern "C" int lif_billboard_march(
    const void* disp, const void* rgbm, const void* ixs, const void* mms,
    const void* abp, void* found, void* tex, void* rgba, int B, int K, int H,
    int W, int pad_lo_x, float cx0, float cy0, float inv_f, float half_ps,
    void* stream) {
  if (K < 1 || K > kMaxPlanes || H < 1 || W < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY, B);
  billboard_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp), static_cast<const float4*>(rgbm),
      static_cast<const int*>(ixs), static_cast<const float*>(mms),
      static_cast<const float*>(abp), static_cast<float*>(found),
      static_cast<float*>(tex), static_cast<float4*>(rgba), K, H, W,
      pad_lo_x, cx0, cy0, inv_f, half_ps);
  return static_cast<int>(cudaGetLastError());
}
