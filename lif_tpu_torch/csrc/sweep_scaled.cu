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
// Design. One thread marches one (pose, row, column) pixel; a block walks
// kTiles (8) tiles of 32 columns x 8 rows of one pose, one after the other,
// and each warp is an 8 x 4 tile of pixels (they cross at closer planes
// than a 32-pixel row's). The pose's (5, K) tables (K <= 1024, 20 KB) and
// per-run ranges are staged in shared memory once per block, so the tiles
// share the staging; the source stays
// row-major and unpadded: a tap's padded index p reads texel clamp(p -
// pad, 0, n - 1) (the texel lif_tpu's edge-replicated pad holds there).
// The TPU layout (the transposed stack, 8-aligned slices with residual
// rolls, hat-candidate class switches, DMA windows) is not carried over.
// The walk, not memory, bounds this kernel: one thread per pixel visits
// 55.6 planes a pixel on the dolly and 136.4 in the tilted orbit's phase
// A, four dependent taps at each (tools/profile_kernels.py). Planes are
// skipped exactly, with the bounds of ops/sweep_scaled.py::
// scaled_skip_tables (built once per texture): b0[y][x] bounds every
// bilinear read with tap origin (x, y) (each tap index clamps on its own,
// so the origin is the first index clamped to [0, n - 2]); b8 and b32 are
// the maxima of b0 over 8x8 and 32x32 origin cells; tables of -disp,
// negated here, serve a decode that falls as the texel rises. Every bound
// is decoded with the kernel's own rounded operations, which are monotone,
// so it bounds every decoded read. Three skips, none of which can change
// an output:
//  - the ladder's top: a block starts one plane before the first plane
//    whose depth any decoded texel can reach (dlim);
//  - per warp, runs of kRun (16) planes: each rounded step of a lane's warp
//    (the products, sums, clip, floor and clamp) is monotone in each of
//    its arguments, so the lane's tap origins over a run lie between those
//    computed from the run's smallest and largest tx, ex (ty, ey) entries;
//    the warp reduces the box of its searching lanes (REDUX), its lanes
//    read the b8 cells (or b32 cells) that cover it, 8 wide and 4 tall, one
//    each, and where their max is not above the run's smallest plane depth
//    the whole run is skipped, uniformly (a run with a non-finite table
//    entry takes the whole source);
//  - per lane, in a run that is not skipped: each lane moves its own
//    cursor over the planes whose b0 entry is not above the plane; at a
//    candidate it stops, and the lanes that stopped read their four taps
//    together.
// A lane leaves at its crossing and no longer widens its warp's box. If
// the plane before the crossing was skipped, its difference is read
// afresh for the secant bracket (lif_tpu's bracket refresh), so found,
// invz* and rgba* are march_scaled_plain's bit for bit; the plain mirror
// of this walk is ops/sweep_scaled.py::march_scaled_skip_plain.
//
// Bound on the H100: the operations of the first-crossing march above the
// crossing (the one-thread walk's yardstick, kept so that times before and
// after this design compare), against 8 bytes per pixel written in
// depth-only mode (24 in color).
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

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxPlanes = 1024;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTileX = 8, kTileY = 4;  // a warp's pixels (SKIP_TILE)
constexpr int kRun = 16;  // planes a warp skips at once (SCALED_RUN)
constexpr int kMaxRuns = kMaxPlanes / kRun;
constexpr int kTiles = 8;  // 32 x 8 tiles a block walks
constexpr int kCoverX = 8, kCoverY = 4;  // a box's cells, over the lanes
constexpr int kTabs = 5;  // tx, ex, ty, ey, invz
constexpr int kRunTabs = 9;  // tx, ex, ty, ey lo and hi, invz lo
constexpr unsigned kAll = 0xffffffffu;

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
// (p + clip(dv)) + pad, its two clamped source indices, the fraction and
// the tap origin (the first index clamped to [0, n - 2]).
struct Taps {
  int i0, i1, o;
  float f;
};

__device__ __forceinline__ Taps taps_of(float dv, float p, float lo, float hi,
                                        int pad, int n) {
  const float g = __fadd_rn(__fadd_rn(p, clampf(dv, lo, hi)),
                            static_cast<float>(pad));
  const float g0 = floorf(g);
  const int i = static_cast<int>(g0) - pad;
  return {clampi(i, 0, n - 1), clampi(i + 1, 0, n - 1), clampi(i, 0, n - 2),
          __fsub_rn(g, g0)};
}

__device__ __forceinline__ Taps taps(float t, float e, float pc, float p,
                                     float lo, float hi, int pad, int n) {
  return taps_of(__fadd_rn(t, __fmul_rn(e, pc)), p, lo, hi, pad, n);
}

// the lowest and highest tap origin along an axis over a run whose tables
// lie in [tlo, thi] x [elo, ehi] (every rounded step is monotone in each
// argument)
__device__ __forceinline__ void run_origins(float tlo, float thi, float elo,
                                            float ehi, float pc, float p,
                                            float lo, float hi, int pad, int n,
                                            int* o0, int* o1) {
  const float ea = __fmul_rn(elo, pc), eb = __fmul_rn(ehi, pc);
  *o0 = taps_of(__fadd_rn(tlo, fminf(ea, eb)), p, lo, hi, pad, n).o;
  *o1 = taps_of(__fadd_rn(thi, fmaxf(ea, eb)), p, lo, hi, pad, n).o;
}

// top = c00*(1-fx) + c01*fx; bot likewise; top*(1-fy) + bot*fy
__device__ __forceinline__ float bil(const float* __restrict__ img, int w,
                                     const Taps& x, const Taps& y) {
  const float gx = __fsub_rn(1.0f, x.f);
  const float gy = __fsub_rn(1.0f, y.f);
  const float* r0 = img + static_cast<size_t>(y.i0) * w;
  const float* r1 = img + static_cast<size_t>(y.i1) * w;
  const float top =
      __fadd_rn(__fmul_rn(__ldg(r0 + x.i0), gx),
                __fmul_rn(__ldg(r0 + x.i1), x.f));
  const float bot =
      __fadd_rn(__fmul_rn(__ldg(r1 + x.i0), gx),
                __fmul_rn(__ldg(r1 + x.i1), x.f));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, y.f));
}

// this lane's cell of the box's cover by cells of side 1 << shift (3: 8,
// 5: 32), laid out 8 wide and 4 tall over the warp's lanes: its bound, or
// -inf outside the cover; *fits is false where the cover is larger
__device__ __forceinline__ float cell_bound(const float* __restrict__ tab,
                                            int tw, int shift, int x0, int x1,
                                            int y0, int y1, int lane,
                                            bool* fits) {
  const int cx0 = x0 >> shift, cy0 = y0 >> shift;
  const int cx1 = x1 >> shift, cy1 = y1 >> shift;
  *fits = cx1 - cx0 < kCoverX && cy1 - cy0 < kCoverY;
  const int cx = cx0 + (lane & (kCoverX - 1)), cy = cy0 + lane / kCoverX;
  if (!*fits || cx > cx1 || cy > cy1) return -INFINITY;
  return __ldg(tab + static_cast<size_t>(cy) * tw + cx);
}

template <bool kColor>
__global__ void __launch_bounds__(kBlockX * kBlockY)
scaled_march_kernel(
    const float* __restrict__ disp,    // (src_h, src_w)
    const float* __restrict__ rgbm,    // (4, src_h, src_w), color mode only
    const float* __restrict__ tabs,    // (B, 5, K): tx, ex, ty, ey, invz
    const float* __restrict__ dlim,    // (2,): min and max disparity texel
    const float* __restrict__ tables,  // b0, b8, b32 (scaled_skip_tables)
    float* __restrict__ found,         // (B, out_h, out_w)
    float* __restrict__ invz_star,     // (B, out_h, out_w)
    float4* __restrict__ rgba_star,    // (B, out_h, out_w), color mode only
    Geo geo, int K, int out_h, int out_w, int refine, float izmin,
    float izmax) {
  __shared__ float s_tab[kTabs][kMaxPlanes];
  __shared__ float s_run[kRunTabs][kMaxRuns];
  __shared__ bool s_sane[kMaxRuns];
  __shared__ int s_k0;
  const int p = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const float rng = __fsub_rn(izmin, izmax);
  const bool down = rng < 0.0f;  // the tables bound -disp
  if (tid == 0) s_k0 = K;
  const float* tp = tabs + static_cast<size_t>(p) * kTabs * K;
  for (int n = tid; n < kTabs * K; n += nthreads) s_tab[n / K][n % K] = tp[n];
  __syncthreads();
  // every decoded read lies within [dmin, dmax] * rng + izmax up to a few
  // roundings, so a plane above this bound cannot cross (NaN never skips)
  {
    const float a = __fmul_rn(__ldg(dlim), rng);
    const float b = __fmul_rn(__ldg(dlim + 1), rng);
    const float hi = __fadd_rn(fmaxf(a, b), izmax);
    const float bound =
        hi + (fmaxf(fabsf(a), fabsf(b)) + fabsf(izmax)) * 1.52587890625e-05f +
        1e-30f;
    for (int k = tid; k < K; k += nthreads) {
      if (!(s_tab[4][k] > bound)) atomicMin(&s_k0, k);
    }
  }
  __syncthreads();
  const int k_start = max(s_k0 - 1, 0);
  // per run of kRun planes from k_start: its table ranges and smallest
  // plane depth (NaN planes cannot cross and are left out of it)
  const int n_runs = (K - k_start + kRun - 1) / kRun;
  for (int r = tid; r < n_runs; r += nthreads) {
    float lo[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
    float hi[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    float vmin = INFINITY;
    bool sane = true;
    const int k0 = k_start + r * kRun, k1 = min(k0 + kRun, K);
    for (int k = k0; k < k1; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float t = s_tab[c][k];
        sane = sane && isfinite(t);
        lo[c] = fminf(lo[c], t);
        hi[c] = fmaxf(hi[c], t);
      }
      vmin = fminf(vmin, s_tab[4][k]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_run[2 * c][r] = lo[c];
      s_run[2 * c + 1][r] = hi[c];
    }
    s_run[8][r] = vmin;
    s_sane[r] = sane;
  }
  __syncthreads();

  // warp threadIdx.y of each 32 x 8 tile is an 8 x 4 tile of pixels; the
  // block walks kTiles such tiles along the row band
  const int lane = threadIdx.x;
  const int i = blockIdx.y * kBlockY + (threadIdx.y / 4) * kTileY +
                lane / kTileX;
  for (int tile = 0; tile < kTiles; ++tile) {
    const int j0 = (blockIdx.x * kTiles + tile) * kBlockX;
    if (j0 >= out_w) break;  // block-uniform: no column left
    const int j = j0 + (threadIdx.y % 4) * kTileX + lane % kTileX;
    const bool valid = j < out_w && i < out_h;

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
    auto diff_of = [&](const Taps& x, const Taps& y, float v) {
      const float tex = bil(disp, geo.src_w, x, y);
      return __fsub_rn(__fadd_rn(__fmul_rn(tex, rng), izmax), v);
    };
    auto diff_at = [&](float tx, float ex, float ty, float ey, float v) {
      return diff_of(tx_of(tx, ex), ty_of(ty, ey), v);
    };
    auto plane_diff = [&](int k) {
      return diff_at(s_tab[0][k], s_tab[1][k], s_tab[2][k], s_tab[3][k],
                     s_tab[4][k]);
    };
    // can a read bounded by b lie in front of plane depth v?
    auto reaches = [&](float b, float v) {
      return b == INFINITY ||
             __fsub_rn(__fadd_rn(__fmul_rn(down ? -b : b, rng), izmax), v) >
                 0.0f;
    };
    const int tw0 = geo.src_w - 1;
    const int tw8 = (tw0 + 7) >> 3, th8 = (geo.src_h - 1 + 7) >> 3;
    const int tw32 = (tw8 + 3) >> 2;
    const float* b0 = tables;
    const float* b8 = b0 + static_cast<size_t>(geo.src_h - 1) * tw0;
    const float* b32 = b8 + static_cast<size_t>(th8) * tw8;

    // pass 1: the first crossing and its bracket
    bool active = valid;
    int ks = -1, pk = -1;  // pd holds the difference at plane pk
    float pd = 0.0f, pdc = 0.0f, dc = 0.0f;
    for (int r = 0, k = k_start; r < n_runs; ++r, k += kRun) {
      if (!__any_sync(kAll, active)) break;
      // the warp's box of tap origins over the run
      int x0 = INT_MAX, x1 = -1, y0 = INT_MAX, y1 = -1;
      if (active) {
        if (s_sane[r]) {
          run_origins(s_run[0][r], s_run[1][r], s_run[2][r], s_run[3][r], xc,
                      jx, geo.x_lo, geo.x_hi, geo.pad_x, geo.src_w, &x0, &x1);
          run_origins(s_run[4][r], s_run[5][r], s_run[6][r], s_run[7][r], yc,
                      iy, geo.y_lo, geo.y_hi, geo.pad_y, geo.src_h, &y0, &y1);
        } else {
          x0 = 0, x1 = geo.src_w - 2, y0 = 0, y1 = geo.src_h - 2;
        }
      }
      x0 = __reduce_min_sync(kAll, x0);
      x1 = __reduce_max_sync(kAll, x1);
      y0 = __reduce_min_sync(kAll, y0);
      y1 = __reduce_max_sync(kAll, y1);
      bool fits;
      float b = cell_bound(b8, tw8, 3, x0, x1, y0, y1, lane, &fits);
      if (!fits) {
        b = cell_bound(b32, tw32, 5, x0, x1, y0, y1, lane, &fits);
        if (!fits) b = INFINITY;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        b = fmaxf(b, __shfl_xor_sync(kAll, b, off));
      }
      if (!reaches(b, s_run[8][r])) continue;  // no lane can cross in this run
      // walk the run: each lane moves its own cursor over the planes whose
      // b0 bound does not reach the plane, then the lanes that stopped at a
      // candidate read its four taps together
      const int k_end = min(k + kRun, K);
      int c = k;
      Taps x, y;
      while (true) {
        while (active && c < k_end) {
          x = tx_of(s_tab[0][c], s_tab[1][c]);
          y = ty_of(s_tab[2][c], s_tab[3][c]);
          if (reaches(__ldg(b0 + static_cast<size_t>(y.o) * tw0 + x.o),
                      s_tab[4][c])) {
            break;
          }
          ++c;
        }
        const bool cand = active && c < k_end;
        if (!__any_sync(kAll, cand)) break;
        if (!cand) continue;
        const float d = diff_of(x, y, s_tab[4][c]);
        if (d > 0.0f) {
          ks = c;
          dc = d;
          // the bracket refresh: the plane before was skipped
          pdc = pk == c - 1 ? pd : (c > 0 ? plane_diff(c - 1) : 0.0f);
          active = false;
        } else {
          pd = d;
          pk = c++;
        }
      }
    }
    if (!valid) continue;
    const size_t o = (static_cast<size_t>(p) * out_h + i) * out_w + j;
    if (ks < 0) {
      found[o] = 0.0f;
      invz_star[o] = 0.0f;
      if constexpr (kColor) rgba_star[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
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
  }  // tiles
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for a ladder longer than kMaxPlanes or a source
// under 2 x 2. rgbm and rgba_star are both null (depth only) or both set
// (full color); tables holds scaled_skip_tables(disp) flattened and
// concatenated. The displacement
// clips are [-pad_x, span_x - pad_x] in x and [-my_lo, my_hi] in y;
// pad_x / pad_y are the padded-coordinate origins.
extern "C" int lif_scaled_march(
    const void* disp, const void* rgbm, const void* tabs, const void* dlim,
    const void* tables, void* found, void* invz_star, void* rgba_star, int B,
    int K, int src_h, int src_w, int out_h, int out_w, int pad_x, int span_x,
    int pad_y, int my_lo, int my_hi, int refine, float izmin, float izmax,
    void* stream) {
  if (K < 1 || K > kMaxPlanes || src_w < 2 || src_h < 2 || refine < 0) {
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
  const int span = kBlockX * kTiles;
  const dim3 grid((out_w + span - 1) / span, (out_h + kBlockY - 1) / kBlockY,
                  B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (rgbm != nullptr) {
    scaled_march_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), static_cast<const float*>(rgbm),
        static_cast<const float*>(tabs), static_cast<const float*>(dlim),
        static_cast<const float*>(tables), static_cast<float*>(found),
        static_cast<float*>(invz_star), static_cast<float4*>(rgba_star), geo,
        K, out_h, out_w, refine, izmin, izmax);
  } else {
    scaled_march_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), nullptr,
        static_cast<const float*>(tabs), static_cast<const float*>(dlim),
        static_cast<const float*>(tables), static_cast<float*>(found),
        static_cast<float*>(invz_star), nullptr, geo, K, out_h, out_w, refine,
        izmin, izmax);
  }
  return static_cast<int>(cudaGetLastError());
}
