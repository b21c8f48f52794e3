// Scaled first-crossing plane march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lif_tpu/ops/pallas/sweep_scaled.py:60 `_kernel`
// (launched by _sweep_scaled). For an aligned pose (no relative rotation)
// the source position of output pixel (i, j) at plane k is separable-affine
// per axis,
//     gx = j + clip(tx[k] + ex[k] * (j - cx0)),
//     gy = i + clip(ty[k] + ey[k] * (i - cy0)),
// with per-pose per-plane tables (tx, ex, ty, ey, invz) and the plan's
// displacement clips. The kernel walks the pose's planes near -> far,
// decodes the bilinear disparity at (gx, gy) to inverse depth
// d = texel * (izmin - izmax) + izmax, and stops at the FIRST plane with
// d > invz[k]. It returns found, the secant-refined crossing invz* (with
// `refine` in-bracket sub-planes at exactly lerped tables, all four warp
// entries being affine in invz) and, in full-color mode, the [r, g, b,
// mask] warps at planes k*-1 and k* lerped at the same s* — the outputs of
// the plain twin lif_tpu_torch.ops.sweep_scaled.march_scaled_plain. The
// production scaled tier and phase A of the two-phase rotated tier run it
// depth only.
//
// Design. One thread marches one (pose, row, column) pixel; a block is 32
// columns x 8 rows of one pose, so a warp reads 32 neighbouring positions
// of one source row band per plane. The pose's (5, K) tables (K <= 1024,
// 20 KB) are staged in shared memory. The TPU layout (the transposed
// (C, W, H) stack, 8-aligned slices with residual rolls, hat-candidate
// class switches, in-kernel transposes, DMA windows, the cm3 and [k_lo,
// k_hi) skip tables) is not carried over: the source stays row-major and
// unpadded, a tap's padded index p reads texel clamp(p - pad, 0, n - 1)
// (the texel lif_tpu's edge-replicated pad holds there), and the disparity
// (4 MB at 1280x800) stays resident in L2 across the pose batch. Per-pixel
// early exit replaces the skip tables; one exact skip is kept: planes
// whose inverse depth lies above every decodable texel cannot host a
// crossing, so a block starts at the plane before the first one that can
// (the bracket's previous diff then comes from that plane, as in the
// twin, which walks from plane 0).
//
// Bound on the H100: a serial per-pixel loop of dependent L2 reads (four
// 4-byte taps per plane until the crossing, plus 4 x refine at it),
// against 8 bytes per pixel written in depth-only mode (24 in color).
// Occupancy is what hides the load latency: no shared-memory tiling of the
// source, since a pose's per-plane footprint moves with the scale.
// FP32 ops: per plane 31, per pixel 2, per found 107.
// (Per visited plane the two clipped taps, the bilinear weights and sum,
// the decode and the test; per pixel the centred offsets; at the crossing
// the refine-2 secant steps.)
//
// Arithmetic: every float operation is an explicitly rounded intrinsic,
// in the twin's order (and the library is built with --fmad=false);
// divisions are true divisions, so a crossing test cannot flip at a tie
// against the twin.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 1024;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTabs = 5;  // tx, ex, ty, ey, invz

struct Geo {
  int src_h, src_w;
  int pad_x, pad_y;       // padded-coordinate origins (lif_tpu's pads)
  float x_lo, x_hi;       // x displacement clip
  float y_lo, y_hi;       // y displacement clip
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// pd / min(pd - d, -1e-12), clipped to [0, 1]
__device__ __forceinline__ float secant(float pd, float d) {
  return clampf(__fdiv_rn(pd, fminf(__fsub_rn(pd, d), -1e-12f)), 0.0f, 1.0f);
}

__device__ __forceinline__ float mix_rn(float lo, float hi, float t) {
  // lo + t * (hi - lo)
  return __fadd_rn(lo, __fmul_rn(t, __fsub_rn(hi, lo)));
}

// One axis of the clipped separable warp: padded coordinate
// (p + clip(t + e * pc)) + pad, its two clamped source indices and the
// fraction.
struct Taps {
  int i0, i1;
  float f;
};

__device__ __forceinline__ Taps taps(float t, float e, float pc, float p,
                                     float lo, float hi, int pad, int n) {
  const float dv = clampf(__fadd_rn(t, __fmul_rn(e, pc)), lo, hi);
  const float g = __fadd_rn(__fadd_rn(p, dv), static_cast<float>(pad));
  const float g0 = floorf(g);
  const int i = static_cast<int>(g0) - pad;
  return {clampi(i, 0, n - 1), clampi(i + 1, 0, n - 1), __fsub_rn(g, g0)};
}

// top = c00*(1-fx) + c01*fx; bot likewise; top*(1-fy) + bot*fy
__device__ __forceinline__ float bil(const float* __restrict__ img, int w,
                                     const Taps& x, const Taps& y) {
  const float gx = __fsub_rn(1.0f, x.f);
  const float gy = __fsub_rn(1.0f, y.f);
  const float* r0 = img + static_cast<size_t>(y.i0) * w;
  const float* r1 = img + static_cast<size_t>(y.i1) * w;
  const float top =
      __fadd_rn(__fmul_rn(__ldg(r0 + x.i0), gx), __fmul_rn(__ldg(r0 + x.i1), x.f));
  const float bot =
      __fadd_rn(__fmul_rn(__ldg(r1 + x.i0), gx), __fmul_rn(__ldg(r1 + x.i1), x.f));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, y.f));
}

template <bool kColor>
__global__ void __launch_bounds__(kBlockX * kBlockY)
scaled_march_kernel(
    const float* __restrict__ disp,  // (src_h, src_w)
    const float* __restrict__ rgbm,  // (4, src_h, src_w), color mode only
    const float* __restrict__ tabs,  // (B, 5, K): tx, ex, ty, ey, invz
    const float* __restrict__ dlim,  // (2,): min and max disparity texel
    float* __restrict__ found,       // (B, out_h, out_w)
    float* __restrict__ invz_star,   // (B, out_h, out_w)
    float4* __restrict__ rgba_star,  // (B, out_h, out_w), color mode only
    Geo geo, int K, int out_h, int out_w, int refine, float izmin,
    float izmax) {
  __shared__ float s_tab[kTabs][kMaxPlanes];
  __shared__ int s_k0;
  const int p = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const float rng = __fsub_rn(izmin, izmax);
  if (tid == 0) s_k0 = K;
  const float* tp = tabs + static_cast<size_t>(p) * kTabs * K;
  for (int n = tid; n < kTabs * K; n += nthreads) s_tab[n / K][n % K] = tp[n];
  __syncthreads();
  // every decoded read lies within [dmin, dmax] * rng + izmax up to a few
  // roundings, so a plane above this bound cannot cross (NaN never skips)
  const float a = __fmul_rn(__ldg(dlim), rng);
  const float b = __fmul_rn(__ldg(dlim + 1), rng);
  const float hi = __fadd_rn(fmaxf(a, b), izmax);
  const float bound =
      hi + (fmaxf(fabsf(a), fabsf(b)) + fabsf(izmax)) * 1.52587890625e-05f +
      1e-30f;
  for (int k = tid; k < K; k += nthreads) {
    if (!(s_tab[4][k] > bound)) atomicMin(&s_k0, k);
  }
  __syncthreads();
  const int k_start = max(s_k0 - 1, 0);

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= out_h || j >= out_w) return;

  const float jx = static_cast<float>(j);
  const float iy = static_cast<float>(i);
  const float xc = __fsub_rn(jx, 0.5f * static_cast<float>(out_w - 1));
  const float yc = __fsub_rn(iy, 0.5f * static_cast<float>(out_h - 1));
  auto tx_of = [&](float t, float e) {
    return taps(t, e, xc, jx, geo.x_lo, geo.x_hi, geo.pad_x, geo.src_w);
  };
  auto ty_of = [&](float t, float e) {
    return taps(t, e, yc, iy, geo.y_lo, geo.y_hi, geo.pad_y, geo.src_h);
  };
  // (warp * rng + izmax) - v
  auto diff_at = [&](float tx, float ex, float ty, float ey, float v) {
    const float tex = bil(disp, geo.src_w, tx_of(tx, ex), ty_of(ty, ey));
    return __fsub_rn(__fadd_rn(__fmul_rn(tex, rng), izmax), v);
  };

  // the first crossing and its bracket
  int ks = -1;
  float pd = 0.0f, pdc = 0.0f, dc = 0.0f;
  for (int k = k_start; k < K; ++k) {
    const float d = diff_at(s_tab[0][k], s_tab[1][k], s_tab[2][k],
                            s_tab[3][k], s_tab[4][k]);
    if (d > 0.0f) {
      ks = k;
      pdc = pd;
      dc = d;
      break;
    }
    pd = d;
  }
  const size_t o = (static_cast<size_t>(p) * out_h + i) * out_w + j;
  if (ks < 0) {
    found[o] = 0.0f;
    invz_star[o] = 0.0f;
    if constexpr (kColor) rgba_star[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int km1 = max(ks - 1, 0);
  float t0[kTabs], t1[kTabs];
#pragma unroll
  for (int c = 0; c < kTabs; ++c) {
    t0[c] = s_tab[c][km1];
    t1[c] = s_tab[c][ks];
  }
  float s_star = secant(pdc, dc);
  if (refine > 0) {
    // in-bracket sub-sweep at exactly lerped tables
    const double step = 1.0 / static_cast<double>(refine + 1);
    float slo = 0.0f, pd2 = pdc, d2 = dc, prev_g = pdc, prev_s = 0.0f;
    bool sfound = false;
    for (int jr = 1; jr <= refine; ++jr) {
      const float s = static_cast<float>(static_cast<double>(jr) * step);
      const float g = diff_at(mix_rn(t0[0], t1[0], s), mix_rn(t0[1], t1[1], s),
                              mix_rn(t0[2], t1[2], s), mix_rn(t0[3], t1[3], s),
                              mix_rn(t0[4], t1[4], s));
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
    s_star = __fadd_rn(slo, __fmul_rn(static_cast<float>(step),
                                      secant(pd2, d2)));
  }
  if (ks == 0) s_star = 1.0f;
  found[o] = 1.0f;
  invz_star[o] = mix_rn(t0[4], t1[4], s_star);
  if constexpr (kColor) {
    // the [r, g, b, mask] warps at the bracketing planes (zero before
    // plane 0), lerped at s*
    const Taps x1 = tx_of(t1[0], t1[1]), y1 = ty_of(t1[2], t1[3]);
    const Taps x0 = tx_of(t0[0], t0[1]), y0 = ty_of(t0[2], t0[3]);
    const size_t plane = static_cast<size_t>(geo.src_h) * geo.src_w;
    float c[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const float* img = rgbm + ch * plane;
      const float c1 = bil(img, geo.src_w, x1, y1);
      const float c0 = ks > 0 ? bil(img, geo.src_w, x0, y0) : 0.0f;
      c[ch] = mix_rn(c0, c1, s_star);
    }
    rgba_star[o] = make_float4(c[0], c[1], c[2], c[3]);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for a ladder longer than kMaxPlanes. rgbm and
// rgba_star are both null (depth only) or both set (full color). The
// displacement clips are [-pad_x, span_x - pad_x] in x and [-my_lo, my_hi]
// in y; pad_x / pad_y are the padded-coordinate origins.
extern "C" int lif_scaled_march(
    const void* disp, const void* rgbm, const void* tabs, const void* dlim,
    void* found, void* invz_star, void* rgba_star, int B, int K, int src_h,
    int src_w, int out_h, int out_w, int pad_x, int span_x, int pad_y,
    int my_lo, int my_hi, int refine, float izmin, float izmax,
    void* stream) {
  if (K < 1 || K > kMaxPlanes || src_w < 1 || src_h < 1 || refine < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo geo{src_h,
                src_w,
                pad_x,
                pad_y,
                -static_cast<float>(pad_x),
                static_cast<float>(span_x - pad_x),
                -static_cast<float>(my_lo),
                static_cast<float>(my_hi)};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((out_w + kBlockX - 1) / kBlockX,
                  (out_h + kBlockY - 1) / kBlockY, B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rgbm != nullptr) {
    scaled_march_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), static_cast<const float*>(rgbm),
        static_cast<const float*>(tabs), static_cast<const float*>(dlim),
        static_cast<float*>(found), static_cast<float*>(invz_star),
        static_cast<float4*>(rgba_star), geo, K, out_h, out_w, refine, izmin,
        izmax);
  } else {
    scaled_march_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), nullptr,
        static_cast<const float*>(tabs), static_cast<const float*>(dlim),
        static_cast<float*>(found), static_cast<float*>(invz_star), nullptr,
        geo, K, out_h, out_w, refine, izmin, izmax);
  }
  return static_cast<int>(cudaGetLastError());
}
