// Billboard splat of a lateral pose batch for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lif_tpu/ops/pallas/splat_march.py:99 `_kernel`
// (launched by render_billboard_batch_pallas). On a lateral pose the
// z-buffered billboard scatter (ops/splat.py::forward_splat) keeps rows:
// source pixel (i, s) covers target pixel (i, s + m) for an integer shift
// m of the pose's ladder iff
//     0 <= s + m <= W-1  and  (m - delta)^2 <= su_half^2,
//     delta = A * t + Bc,  t = disp[i, s],
//     su_half = max(half_ps * sqrt(xterm + yterm + 1), 0.5),
//     xterm = ((s + 0.5 - cx0) * inv_f)^2,  yterm = ((i + 0.5 - cy0) * inv_f)^2,
// and each target pixel shows its nearest cover: the largest t, the lower
// source column among equal t. lif_tpu computes this as the gather dual
// (each target pixel walks the ladder near -> far: the first covered plane,
// then the chain of strictly nearer or lower-id upgrades). While su_half < 1
// the two agree: two covering shifts two or more apart have deltas at least
// 2 - 2 su_half > 0 apart in ladder order, so the farther one is farther
// and only neighbouring rungs compete, which the chain resolves. Outputs:
// found, the winner's disparity texel (-1 where none) and its
// [r, g, b, mask] point texel (0 where none) — what the plain version
// lif_tpu_torch.ops.splat_march.billboard_scatter_plain returns, and the
// dual's twin billboard_march_plain with it.
//
// Design: a scatter into a row z-buffer, no ladder walk. A block holds P
// poses (P <= 4, fewer where W is wide) and a few rows; its dynamic shared
// memory is one u64 key per (pose, column) of the current row. The key is
// the inverted order-preserving map of t in the high 32 bits and the
// source column in the low 32, so the smallest key is the winner and
// atomicMin gives the same final key in any order. Per row, each thread
// takes source columns s (coalesced loads of disp), computes su_half once
// for all P poses, and per pose tests the at most 3 integer shifts around
// delta inside the ladder's shift range [min mms, max mms] (each block
// reduces it from mms), issuing a shared atomicMin per covered target.
// After a barrier each thread
// decodes the keys of its target columns, writes found / tex and the
// winner's [r, g, b, mask] as one float4 read from the (H, W, 4) stack,
// and resets the entry for the next row.
//
// Bound on the H100: bytes. Per pose and source pixel the splat reads
// 4 (disp) + 16 (colour) bytes once and per target pixel writes 24, and
// its float work is O(1) per source pixel:
// FP32 ops: per plane 0, per pixel 32, per found 0.
// (delta 2; su_half 13: x and y offsets 3 + 3, their squares 2, two adds,
// sqrt, scale, max; su^2 1; and for each of at most 4 footprint pixels a
// cover test — subtract, square, compare — and a depth compare, 16.) This
// kernel does the splat's work (3 cover tests instead of 4, su_half shared
// by the block's poses) plus one shared-memory atomic per cover; its
// traffic is the output writes and the winners' L2-resident colour reads.
//
// Arithmetic: every float operation is an explicitly rounded intrinsic in
// the plain versions' order (the library is built with --fmad=false),
// inv_f is the host-rounded float32 1/f1 and half_ps the float32
// 0.5 * point_size, so the kernel and both plain versions agree bit for
// bit.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPoses = 4;        // poses per block
constexpr int kRows = 4;            // rows per block
constexpr int kSmemTarget = 65536;  // bytes of z-buffer a block aims at
constexpr int kSmemMax = 232448;    // a block's shared-memory limit
constexpr unsigned long long kNoKey = ~0ull;

// larger t -> smaller key; -0.0 keys as +0.0 (the dual finds them equal)
__device__ __forceinline__ unsigned int depth_order(float t) {
  const unsigned int u = __float_as_uint(t == 0.0f ? 0.0f : t);
  const unsigned int order = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~order;
}

__global__ void __launch_bounds__(kThreads)
billboard_kernel(
    const float* __restrict__ disp,   // (H, W)
    const float4* __restrict__ rgbm,  // (H, W): r, g, b, mask
    const float* __restrict__ mms,    // (B, K) integer shifts m
    const float* __restrict__ abp,    // (B, 3): A, Bc, su_half_max
    float* __restrict__ found,        // (B, H, W)
    float* __restrict__ tex,          // (B, H, W)
    float4* __restrict__ rgba,        // (B, H, W)
    int B, int K, int H, int W, int poses, float cx0, float cy0, float inv_f,
    float half_ps) {
  extern __shared__ unsigned long long s_key[];  // (poses, W)
  __shared__ int s_mlo[kMaxPoses], s_mhi[kMaxPoses];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * poses;
  const int np = min(poses, B - p0);
  if (tid < kMaxPoses) {
    s_mlo[tid] = INT_MAX;
    s_mhi[tid] = INT_MIN;
  }
  for (int e = tid; e < np * W; e += kThreads) s_key[e] = kNoKey;
  __syncthreads();
  for (int e = tid; e < np * K; e += kThreads) {
    const int m = static_cast<int>(mms[static_cast<size_t>(p0) * K + e]);
    atomicMin(&s_mlo[e / K], m);
    atomicMax(&s_mhi[e / K], m);
  }
  __syncthreads();
  float A[kMaxPoses], Bc[kMaxPoses];
  int mlo[kMaxPoses], mhi[kMaxPoses];
#pragma unroll
  for (int q = 0; q < kMaxPoses; ++q) {
    const int p = p0 + min(q, np - 1);
    A[q] = __ldg(abp + 3 * p);
    Bc[q] = __ldg(abp + 3 * p + 1);
    mlo[q] = s_mlo[min(q, np - 1)];
    mhi[q] = s_mhi[min(q, np - 1)];
  }

  const int i_end = min(H, (blockIdx.x + 1) * kRows);
  for (int i = blockIdx.x * kRows; i < i_end; ++i) {
    const float yv = __fmul_rn(
        __fsub_rn(__fadd_rn(static_cast<float>(i), 0.5f), cy0), inv_f);
    const float yterm = __fmul_rn(yv, yv);
    const float* row = disp + static_cast<size_t>(i) * W;
    // scatter: every source column of the row, every pose of the block
    for (int s = tid; s < W; s += kThreads) {
      const float t = __ldg(row + s);
      const float xv = __fmul_rn(
          __fsub_rn(__fadd_rn(static_cast<float>(s), 0.5f), cx0), inv_f);
      const float su = fmaxf(
          __fmul_rn(half_ps,
                    __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(xv, xv), yterm),
                                         1.0f))),
          0.5f);
      const float su2 = __fmul_rn(su, su);
      const unsigned long long key =
          (static_cast<unsigned long long>(depth_order(t)) << 32) |
          static_cast<unsigned int>(s);
#pragma unroll
      for (int q = 0; q < kMaxPoses; ++q) {
        if (q >= np) break;
        const float delta = __fadd_rn(__fmul_rn(A[q], t), Bc[q]);
        const float r = rintf(delta);
        // shifts within 1.5 of delta; false for NaN or far outside
        if (!(r >= static_cast<float>(mlo[q]) - 1.0f &&
              r <= static_cast<float>(mhi[q]) + 1.0f)) {
          continue;
        }
        const int mc = static_cast<int>(r);
#pragma unroll
        for (int c = -1; c <= 1; ++c) {
          const int m = mc + c;
          const int o = s + m;
          if (m < mlo[q] || m > mhi[q] || o < 0 || o >= W) continue;
          const float d = __fsub_rn(static_cast<float>(m), delta);
          if (__fmul_rn(d, d) <= su2) atomicMin(&s_key[q * W + o], key);
        }
      }
    }
    __syncthreads();
    // resolve: decode each target column's key, reset it for the next row
    for (int e = tid; e < np * W; e += kThreads) {
      const int q = e / W, o = e - q * W;
      const unsigned long long key = s_key[e];
      s_key[e] = kNoKey;
      const size_t out = (static_cast<size_t>(p0 + q) * H + i) * W + o;
      if (key != kNoKey) {
        const int s = static_cast<int>(key & 0xFFFFFFFFull);
        found[out] = 1.0f;
        tex[out] = __ldg(row + s);
        rgba[out] = __ldg(rgbm + static_cast<size_t>(i) * W + s);
      } else {
        found[out] = 0.0f;
        tex[out] = -1.0f;
        rgba[out] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for bad sizes or a row too wide for one block's
// shared memory.
extern "C" int lif_billboard_march(
    const void* disp, const void* rgbm, const void* mms, const void* abp,
    void* found, void* tex, void* rgba, int B, int K, int H, int W, float cx0,
    float cy0, float inv_f, float half_ps, void* stream) {
  if (K < 1 || H < 1 || W < 1 || B < 1 ||
      static_cast<long long>(W) * 8 > kSmemMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_bytes = W * 8;
  const int poses =
      max(1, min(min(kMaxPoses, B), min(kSmemTarget, kSmemMax) / row_bytes));
  const int smem = poses * row_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        billboard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((H + kRows - 1) / kRows, (B + poses - 1) / poses);
  billboard_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp), static_cast<const float4*>(rgbm),
      static_cast<const float*>(mms), static_cast<const float*>(abp),
      static_cast<float*>(found), static_cast<float*>(tex),
      static_cast<float4*>(rgba), B, K, H, W, poses, cx0, cy0, inv_f,
      half_ps);
  return static_cast<int>(cudaGetLastError());
}
