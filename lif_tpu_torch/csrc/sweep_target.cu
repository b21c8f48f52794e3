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
// 32 columns x 8 rows of one pose and each warp an 8 x 4 tile of it (its
// pixels cross at closer planes than a 32-pixel row's do, so its skips
// leave it fewer planes to walk). The pose's ladder and thresholds
// (K <= 1024) are staged in shared memory, and the source stays
// row-major. The walk, not memory, bounds this kernel: without skips a
// pixel of the orbit visits 134 planes, reading four taps at each
// (tools/profile_kernels.py). Planes are skipped
// exactly, with the bounds of ops/sweep_target.py::skip_tables (built
// once per launch in plain torch, as lif_tpu builds its cm3 outside its
// kernel): b0[y][x] bounds every bilinear read with tap origin (x, y) (the
// max of its taps plus max|tap| * 2^-16 + 1e-30: a read is a convex
// combination of its taps up to a few roundings), b8 and b32 the maxima
// of b0 over 8x8 and 32x32 origin cells. Three skips, none of which can
// change an output:
//  - the ladder's padding: a block starts one plane before the first
//    plane whose threshold any texel can reach;
//  - per warp, runs of kRun planes: a lane's positions over a run lie
//    between those at the run's smallest and largest v (affine in v,
//    monotone rounding), so the warp reduces the box of its searching
//    lanes' tap origins (REDUX), its lanes read the b8 cells (or b32
//    cells) that cover it, 8 wide and 4 tall, one each, and where their
//    max is not above the run's lowest threshold the whole run is
//    skipped, uniformly;
//  - per lane, in a run that is not skipped: each lane moves its own
//    cursor over the planes whose b0 entry is not above the threshold;
//    at a plane whose b0 entry is (a candidate) it stops, and the lanes
//    that stopped read their four taps together, so a warp pays for a tap
//    read about once per candidate round rather than once per plane where
//    any lane needs one.
// A lane leaves at its crossing and no longer widens its warp's box. If
// the plane before the crossing was skipped, its difference is read
// afresh for the secant bracket (lif_tpu's bracket refresh), so found,
// invz* and rgba* are march_target_plain's bit for bit; the plain mirror
// of this walk is ops/sweep_target.py::march_target_skip_plain.
//
// Bound on the H100: the operations of the first-crossing march above the
// crossing (the plain walk's yardstick, kept so that times before and
// after this design compare), four bilinear taps and a test per plane,
// against an 8-byte (depth) or 24-byte (color) output write per pixel.
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

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxPlanes = 1024;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kTileX = 8, kTileY = 4;  // a warp's pixels (SKIP_TILE)
constexpr int kRun = 24;  // planes a warp skips at once (SKIP_RUN)
constexpr int kMaxRuns = kMaxPlanes / kRun + 1;
constexpr int kCoverX = 8, kCoverY = 4;  // a box's cells, over the lanes
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// _bil's tap origin along an axis of n texels (NaN -> 0)
__device__ __forceinline__ int origin(float p, int n) {
  return static_cast<int>(
      fminf(fmaxf(floorf(p), 0.0f), static_cast<float>(n - 2)));
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
target_march_kernel(
    const float* __restrict__ disp,    // (src_h, src_w)
    const float* __restrict__ rgbm,    // (4, src_h, src_w), color mode only
    const float* __restrict__ pose,    // (B, 16): p_ts row-major, c_vec
    const float* __restrict__ vg,      // (B, K) plane invz, descending
    const float* __restrict__ tk,      // (B, K) texel thresholds
    const float* __restrict__ dmax,    // (1,) max disparity texel
    const float* __restrict__ tables,  // b0, b8, b32 (skip_tables), flat
    float* __restrict__ found,         // (B, out_h, out_w)
    float* __restrict__ invz_star,     // (B, out_h, out_w)
    float4* __restrict__ rgba_star,    // (B, out_h, out_w), color mode only
    int K, int src_h, int src_w, int out_h, int out_w, int refine) {
  __shared__ float s_v[kMaxPlanes];
  __shared__ float s_t[kMaxPlanes];
  __shared__ float s_vlo[kMaxRuns], s_vhi[kMaxRuns], s_tmin[kMaxRuns];
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
  // per run of kRun planes from k_start: its v range and lowest threshold
  // (NaN planes cannot cross and are left out)
  const int n_runs = (K - k_start + kRun - 1) / kRun;
  for (int r = tid; r < n_runs; r += nthreads) {
    float vlo = INFINITY, vhi = -INFINITY, tmin = INFINITY;
    const int k0 = k_start + r * kRun, k1 = min(k0 + kRun, K);
    for (int k = k0; k < k1; ++k) {
      vlo = fminf(vlo, s_v[k]);
      vhi = fmaxf(vhi, s_v[k]);
      tmin = fminf(tmin, s_t[k]);
    }
    s_vlo[r] = vlo;
    s_vhi[r] = vhi;
    s_tmin[r] = tmin;
  }
  __syncthreads();

  // warp threadIdx.y of the block's 32 x 8 pixels is an 8 x 4 tile
  const int lane = threadIdx.x;
  const int j = blockIdx.x * kBlockX + (threadIdx.y % 4) * kTileX +
                lane % kTileX;
  const int i = blockIdx.y * kBlockY + (threadIdx.y / 4) * kTileY +
                lane / kTileX;
  const bool valid = j < out_w && i < out_h;

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
  const bool sane =
      isfinite(ax) && isfinite(dx) && isfinite(ay) && isfinite(dy);
  const int tw0 = src_w - 1;
  const int tw8 = (tw0 + 7) >> 3, th8 = (src_h - 1 + 7) >> 3;
  const int tw32 = (tw8 + 3) >> 2;
  const float* b0 = tables;
  const float* b8 = b0 + static_cast<size_t>(src_h - 1) * tw0;
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
      const float xa = __fadd_rn(ax, __fmul_rn(s_vlo[r], dx));
      const float xb = __fadd_rn(ax, __fmul_rn(s_vhi[r], dx));
      const float ya = __fadd_rn(ay, __fmul_rn(s_vlo[r], dy));
      const float yb = __fadd_rn(ay, __fmul_rn(s_vhi[r], dy));
      if (!sane || isnan(xa) || isnan(xb) || isnan(ya) || isnan(yb)) {
        x0 = 0, x1 = src_w - 2, y0 = 0, y1 = src_h - 2;
      } else {
        const int oxa = origin(xa, src_w), oxb = origin(xb, src_w);
        const int oya = origin(ya, src_h), oyb = origin(yb, src_h);
        x0 = min(oxa, oxb), x1 = max(oxa, oxb);
        y0 = min(oya, oyb), y1 = max(oya, oyb);
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
    if (!(b > s_tmin[r])) continue;  // no lane can cross in this run
    // walk the run: each lane moves its own cursor over the planes whose
    // b0 bound stays at or under the threshold, then the lanes that stopped
    // at a candidate read its four taps together
    const int k_end = min(k + kRun, K);
    int c = k;
    while (true) {
      while (active && c < k_end) {
        const float px = __fadd_rn(ax, __fmul_rn(s_v[c], dx));
        const float py = __fadd_rn(ay, __fmul_rn(s_v[c], dy));
        if (__ldg(b0 + static_cast<size_t>(origin(py, src_h)) * tw0 +
                  origin(px, src_w)) > s_t[c]) {
          break;
        }
        ++c;
      }
      const bool cand = active && c < k_end;
      if (!__any_sync(kAll, cand)) break;
      if (!cand) continue;
      const float d = __fsub_rn(tex_at(s_v[c]), s_t[c]);
      if (d > 0.0f) {
        ks = c;
        dc = d;
        // the bracket refresh: the plane before was skipped
        pdc = pk == c - 1 ? pd : __fsub_rn(tex_at(s_v[c - 1]), s_t[c - 1]);
        active = false;
      } else {
        pd = d;
        pk = c++;
      }
    }
  }
  if (!valid) return;
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
// rgba_star are both null (depth only) or both set (full color); tables
// holds skip_tables(disp) flattened and concatenated.
extern "C" int lif_target_march(
    const void* disp, const void* rgbm, const void* pose, const void* vg,
    const void* tk, const void* dmax, const void* tables, void* found,
    void* invz_star, void* rgba_star, int B, int K, int src_h, int src_w,
    int out_h, int out_w, int refine, void* stream) {
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
        static_cast<const float*>(tables), static_cast<float*>(found),
        static_cast<float*>(invz_star), static_cast<float4*>(rgba_star), K,
        src_h, src_w, out_h, out_w, refine);
  } else {
    target_march_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const float*>(disp), nullptr,
        static_cast<const float*>(pose), static_cast<const float*>(vg),
        static_cast<const float*>(tk), static_cast<const float*>(dmax),
        static_cast<const float*>(tables), static_cast<float*>(found),
        static_cast<float*>(invz_star), nullptr, K, src_h, src_w, out_h,
        out_w, refine);
  }
  return static_cast<int>(cudaGetLastError());
}
