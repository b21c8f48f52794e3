// Lateral first-crossing plane march for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lif_tpu/ops/pallas/sweep_march.py::_kernel
// (launched by _sweep_lateral). For every pose p and output pixel (i, j)
// it walks the pose's planes (a snap, uniform or hybrid ladder) near ->
// far over the x-shifted source disparity, finds the FIRST plane k whose warped inverse depth lies in
// front of the plane (diff > 0), and returns the secant-refined crossing
// invz* (with `refine` in-bracket sub-planes) and the color lerped between
// the warps at planes k-1 and k — the outputs found / invz* / rgba* of the
// plain twin lif_tpu_torch.ops.sweep_march.march_translation_plain, bit
// for bit.
//
// Design. A block is 8 rows of one pose and walks kTiles (8) tiles of 32
// columns, one after the other; each warp is one row of a tile, 32
// neighbouring columns, so a plane's shifted read is one coalesced load of
// 33 floats. The pose's shifts, fractions and plane depths are staged in
// shared memory, with per run of kRun (16) planes (runs aligned at
// multiples of kRun) the smallest and largest shift and the smallest plane
// depth: once per block where K <= kMaxPlanes (1024), the tiles sharing
// that staging; a longer ladder (a uniform grid of more planes) is walked
// in segments of kMaxPlanes planes, each staged in turn by the whole
// block for every tile, the walk's state (the previous plane's difference,
// the crossing and its bracket) carried across a segment's end, and a
// plane of an earlier segment (the bracket refresh, the colour at k - 1)
// read from global memory. Column
// clamping replaces the edge padding of the TPU layout (the transposed
// stack, 8-aligned slices, 128-lane pads and flattened SMEM tables are
// TPU constraints and are gone). Each lane searches its (band x 128-row)
// cell's plane range [k_lo, k_hi) of the bounds tables
// (lif_tpu_torch/ops/bounds.py). The
// walk, not memory, bounds this kernel: one thread walking its range
// visits about 115 planes a pixel on the lateral drive, a dependent load
// chain at each (tools/profile_kernels.py). Two things cut it, neither of
// which can change an output:
//  - per warp, runs of planes skipped whole: over a run, the warp's
//    searching lanes read tap origins in the row window [jmin - pad + min
//    ix, jmax - pad + max ix] (clamped to the row); the row tables of
//    ops/sweep_march.py::row_skip_tables (built once per texture, r8 and
//    r32 the maxima over 8- and 32-texel cells of a pair bound r0 that
//    is at least every lerp with that origin) bound every texel read
//    there; the lanes read the cells covering the window, one each, and
//    where that bound, decoded with the kernel's own rounded operations
//    (monotone, so it bounds every decoded read), is not above the run's
//    smallest plane depth no lane can cross in the run. Tables of -disp,
//    negated here, serve a decode that falls as the texel rises;
//  - in a run that is not skipped, a lane reads kGroup planes together
//    (independent loads) before it tests them in order, instead of one
//    dependent load and branch at a time.
// A lane leaves at its crossing or at k_hi and no longer widens its warp's
// window. If the plane before the crossing was not read, its difference is
// read afresh for the secant bracket (lif_tpu's bracket refresh), so the
// outputs are the dense walk's. The plain mirror of this walk is
// ops/sweep_march.py::march_translation_skip_plain.
//
// Bound on the H100: the operations of the first-crossing march above the
// crossing (the one-thread walk's yardstick, kept so that times before and
// after this design compare), against a 24-byte output write per pixel.
// FP32 ops: per plane 8, per pixel 0, per found 52.
// (Per visited plane the lerp, the decode and the crossing test; at
// the crossing the secant and nine lerps.)
//
// Arithmetic: every float operation of the crossing test, the secant and
// the lerps is an explicitly rounded intrinsic (and the library is built
// with --fmad=false), in the order the plain twin evaluates it, so a
// contracted multiply-add cannot flip a tie of diff > 0.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "epilogue.cuh"

namespace {

constexpr int kMaxPlanes = 1024;
constexpr int kBlockX = 32;  // a warp: 32 columns of one row
constexpr int kBlockY = 8;
constexpr int kRun = 16;  // planes a warp skips at once (LATERAL_RUN)
constexpr int kMaxRuns = kMaxPlanes / kRun;
constexpr int kTiles = 8;  // 32-column tiles a block walks
constexpr int kGroup = 4;  // planes a lane reads together (LATERAL_GROUP)
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // a * (1 - f) + b * f
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

__device__ __forceinline__ float mix_rn(float lo, float hi, float s) {
  // lo + s * (hi - lo)
  return __fadd_rn(lo, __fmul_rn(s, __fsub_rn(hi, lo)));
}

// pd / min(pd - d, -1e-12), clipped to [0, 1]
__device__ __forceinline__ float secant(float pd, float d) {
  return fminf(fmaxf(__fdiv_rn(pd, fminf(__fsub_rn(pd, d), -1e-12f)), 0.0f),
               1.0f);
}

// this lane's cell of the row-window cover [xa, xb]: 8-texel cells where
// at most 32 cover it, else 32-texel cells, else +inf; -inf past the cover
__device__ __forceinline__ float row_bound(const float* __restrict__ r8,
                                           const float* __restrict__ r32,
                                           int xa, int xb, int lane) {
  int ca = xa >> 3, cb = xb >> 3;
  if (cb - ca < 32) {
    return ca + lane <= cb ? __ldg(r8 + ca + lane) : -INFINITY;
  }
  ca = xa >> 5, cb = xb >> 5;
  if (cb - ca < 32) {
    return ca + lane <= cb ? __ldg(r32 + ca + lane) : -INFINITY;
  }
  return INFINITY;
}

// one plane's window start, fraction and inverse depth
struct Plane {
  int ix;
  float fx, iz;
};

// one pose's plane tables of [seg0, seg0 + n) and their run minima into
// shared memory (every thread of the block calls it)
__device__ __forceinline__ void stage_segment(
    const int* __restrict__ ix, const float* __restrict__ fx,
    const float* __restrict__ izt, size_t pose0, int seg0, int n, int* s_ix,
    float* s_fx, float* s_iz, int* s_ixlo, int* s_ixhi, float* s_tmin) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < n; k += nthreads) {
    const size_t o = pose0 + seg0 + k;
    s_ix[k] = ix[o];
    s_fx[k] = fx[o];
    s_iz[k] = izt[o];
  }
  __syncthreads();
  // per run: its shift range and smallest plane invz (NaN planes cannot
  // cross and are left out)
  const int n_runs = (n + kRun - 1) / kRun;
  for (int r = tid; r < n_runs; r += nthreads) {
    int lo = INT_MAX, hi = INT_MIN;
    float tmin = INFINITY;
    for (int k = r * kRun; k < min(r * kRun + kRun, n); ++k) {
      lo = min(lo, s_ix[k]);
      hi = max(hi, s_ix[k]);
      tmin = fminf(tmin, s_iz[k]);
    }
    s_ixlo[r] = lo;
    s_ixhi[r] = hi;
    s_tmin[r] = tmin;
  }
  __syncthreads();
}

// kSegmented: K > kMaxPlanes, the ladder walked in staged segments; the
// other instantiation stages the whole ladder once (the common case)
template <bool kSegmented>
__global__ void __launch_bounds__(kBlockX * kBlockY) lateral_march_kernel(
    const float* __restrict__ src,   // (5, H, W): r, g, b, mask, disp
    const int* __restrict__ ix,      // (B, K) window starts, padded coords
    const float* __restrict__ fx,    // (B, K) lerp fractions
    const float* __restrict__ izt,   // (B, K) plane invz, near -> far
    const int* __restrict__ klo,     // (B, nb, n_hc) first plane to visit
    const int* __restrict__ khi,     // (B, nb, n_hc) one past the last
    const float* __restrict__ r8,    // (H, n8) row_skip_tables
    const float* __restrict__ r32,   // (H, n32)
    float* __restrict__ found,       // (B, H, out_w)
    float* __restrict__ invz_star,   // (B, H, out_w)
    float4* __restrict__ rgba_star,  // (B, H, out_w)
    int K, int H, int W, int out_w, int pad_lo_x, int tw, int n_hc, int n8,
    int n32, float izmin, float izmax, int refine) {
  __shared__ int s_ix[kMaxPlanes];
  __shared__ float s_fx[kMaxPlanes], s_iz[kMaxPlanes];
  __shared__ int s_ixlo[kMaxRuns], s_ixhi[kMaxRuns];
  __shared__ float s_tmin[kMaxRuns];
  const int p = blockIdx.z;
  const size_t pose0 = static_cast<size_t>(p) * K;
  // one staged segment for the whole block, or several, staged in turn
  // for every tile (the block's threads all reach each __syncthreads: a
  // row past H walks nothing but stays)
  const int last0 = (K - 1) / kMaxPlanes * kMaxPlanes;  // the last segment
  if (!kSegmented) {
    stage_segment(ix, fx, izt, pose0, 0, K, s_ix, s_fx, s_iz, s_ixlo,
                  s_ixhi, s_tmin);
  }

  const int lane = threadIdx.x;
  const int i = blockIdx.y * kBlockY + threadIdx.y;  // row, warp-uniform
  const bool row_ok = i < H;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t row = static_cast<size_t>(min(i, H - 1)) * W;
  const float* disp = src + 4 * plane + row;
  const float dsc = __fsub_rn(izmin, izmax);
  const bool down = dsc < 0.0f;  // the tables bound -disp
  const float* row8 = r8 + static_cast<size_t>(min(i, H - 1)) * n8;
  const float* row32 = r32 + static_cast<size_t>(min(i, H - 1)) * n32;
  for (int tile = 0; tile < kTiles; ++tile) {
    const int j = (blockIdx.x * kTiles + tile) * kBlockX + lane;  // column
    if (j - lane >= out_w) break;  // block-uniform: no column left
    const bool valid = row_ok && j < out_w;
    int k0 = K, k1 = 0;
    if (valid) {
      const int cell = (p * (out_w / tw) + j / tw) * n_hc + i / 128;
      k0 = klo[cell];
      k1 = khi[cell];
    }

    const int x0 = j - pad_lo_x;  // source column of window start 0

    auto tap = [&](int start, int d) {
      return min(max(x0 + start + d, 0), W - 1);
    };
    // decoded inverse depth of the warped disparity minus the plane's, at
    // shift s + f and plane invz z
    auto diff_of = [&](int s, float f, float z) {
      const float tex = lerp_rn(disp[tap(s, 0)], disp[tap(s, 1)], f);
      return __fsub_rn(__fadd_rn(__fmul_rn(tex, dsc), izmax), z);
    };
    // plane k's shift, fraction and invz: staged in shared memory from
    // seg0 on, else (an earlier segment) read from global memory
    auto plane_at = [&](int k, int seg0) {
      if (!kSegmented || k >= seg0) {
        return Plane{s_ix[k - seg0], s_fx[k - seg0], s_iz[k - seg0]};
      }
      return Plane{__ldg(ix + pose0 + k), __ldg(fx + pose0 + k),
                   __ldg(izt + pose0 + k)};
    };

    // pass 1: the first crossing and its bracket, segment by segment
    bool active = valid && k0 < k1;
    int ks = -1, pk = -1;  // pd holds the difference at plane pk
    float pd = 0.0f, pdc = 0.0f, dc = 0.0f;
    const int kw0 = __reduce_min_sync(kAll, active ? k0 : K);
    const int kw1 = __reduce_max_sync(kAll, active ? k1 : 0);
    for (int seg0 = 0; seg0 < (kSegmented ? K : 1); seg0 += kMaxPlanes) {
      const int seg1 = kSegmented ? min(seg0 + kMaxPlanes, K) : K;
      if (kSegmented) {
        __syncthreads();  // every read of the previous staging is done
        stage_segment(ix, fx, izt, pose0, seg0, seg1 - seg0, s_ix, s_fx,
                      s_iz, s_ixlo, s_ixhi, s_tmin);
      }
      // the segment's planes, staged from seg0
      auto diff_at = [&](int k) {
        return diff_of(s_ix[k - seg0], s_fx[k - seg0], s_iz[k - seg0]);
      };
      for (int r = max(kw0, seg0) / kRun; r * kRun < min(kw1, seg1); ++r) {
        const int kb = r * kRun;
        const int rs = r - seg0 / kRun;  // the run within the segment
        if (active && k1 <= kb) active = false;
        if (!__any_sync(kAll, active)) break;
        // the warp's window of tap origins over the run
        const int jlo = __reduce_min_sync(kAll, active ? j : INT_MAX);
        const int jhi = __reduce_max_sync(kAll, active ? j : INT_MIN);
        const int xa = min(max(jlo - pad_lo_x + s_ixlo[rs], 0), W - 1);
        const int xb = min(max(jhi - pad_lo_x + s_ixhi[rs], 0), W - 1);
        float m = row_bound(row8, row32, xa, xb, lane);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
        }
        const float top = __fadd_rn(__fmul_rn(down ? -m : m, dsc), izmax);
        if (m != INFINITY && !(__fsub_rn(top, s_tmin[rs]) > 0.0f)) continue;
        // walk the run: kGroup planes read together, then tested in order
        const int ke = min(kb + kRun, K);
        for (int c = kb + max(kw0 - kb, 0) / kGroup * kGroup; c < ke;
             c += kGroup) {
          if (!__any_sync(kAll, active)) break;
          if (!active) continue;
          float d[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) d[u] = diff_at(min(c + u, ke - 1));
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int cc = c + u;
            if (!active || cc >= ke) break;
            if (cc >= k1) {
              active = false;
              break;
            }
            if (cc < k0) continue;
            if (d[u] > 0.0f) {
              ks = cc;
              dc = d[u];
              // the bracket refresh: the plane before was not read (it may
              // lie in the previous segment)
              if (pk == cc - 1) {
                pdc = pd;
              } else if (cc > 0) {
                const Plane q = plane_at(cc - 1, seg0);
                pdc = diff_of(q.ix, q.fx, q.iz);
              } else {
                pdc = 0.0f;
              }
              active = false;
            } else {
              pd = d[u];
              pk = cc;
            }
          }
        }
      }
    }
    if (!valid) continue;

    const size_t o = (static_cast<size_t>(p) * H + i) * out_w + j;
    if (ks < 0) {
      found[o] = 0.0f;
      invz_star[o] = 0.0f;
      rgba_star[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    // the [r, g, b, mask] warps at a shift t (ix + fx, or a sub-plane's)
    auto color_at = [&](float t, float* out) {
      const float tf = floorf(t);
      const int a = tap(static_cast<int>(tf), 0);
      const int b = tap(static_cast<int>(tf), 1);
      const float f = __fsub_rn(t, tf);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const float* cp = src + ch * plane + row;
        out[ch] = lerp_rn(cp[a], cp[b], f);
      }
    };
    // the bracket's planes, from the segment staged last (or before it)
    const int km1 = max(ks - 1, 0);
    const Plane q0 = plane_at(km1, kSegmented ? last0 : 0);
    const Plane q1 = plane_at(ks, kSegmented ? last0 : 0);
    const float iz0 = q0.iz, iz1 = q1.iz;
    const float tx0 = __fadd_rn(static_cast<float>(q0.ix), q0.fx);
    const float tx1 = __fadd_rn(static_cast<float>(q1.ix), q1.fx);
    float cur[4], prev[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c[4];
    color_at(tx1, cur);
    float s_star = 1.0f;  // a first-plane crossing snaps to plane 0
    if (ks == 0) {
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) c[ch] = cur[ch];
    } else if (refine == 0) {
      color_at(tx0, prev);
      s_star = secant(pdc, dc);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) c[ch] = mix_rn(prev[ch], cur[ch], s_star);
    } else {
      // in-bracket sub-sweep at exactly lerped shifts and plane depths
      color_at(tx0, prev);
      const double step = 1.0 / static_cast<double>(refine + 1);
      float slo = 0.0f, pd2 = pdc, d2 = dc, prev_g = pdc, prev_s = 0.0f;
      float clo[4], chi[4], prev_c[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        clo[ch] = prev[ch];
        chi[ch] = cur[ch];
        prev_c[ch] = prev[ch];
      }
      bool sfound = false;
      for (int jj = 1; jj <= refine + 1; ++jj) {
        const float s = static_cast<float>(static_cast<double>(jj) * step);
        float g, cs[4];
        if (jj <= refine) {
          const float t = mix_rn(tx0, tx1, s);
          const float tf = floorf(t);
          const float tex = lerp_rn(disp[tap(static_cast<int>(tf), 0)],
                                    disp[tap(static_cast<int>(tf), 1)],
                                    __fsub_rn(t, tf));
          g = __fsub_rn(__fadd_rn(__fmul_rn(tex, dsc), izmax),
                        mix_rn(iz0, iz1, s));
          color_at(t, cs);
        } else {
          g = dc;
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) cs[ch] = cur[ch];
        }
        if (!sfound && g > 0.0f) {
          slo = prev_s;
          pd2 = prev_g;
          d2 = g;
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            clo[ch] = prev_c[ch];
            chi[ch] = cs[ch];
          }
          sfound = true;
        }
        prev_g = g;
        prev_s = s;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) prev_c[ch] = cs[ch];
      }
      if (!sfound) {
        slo = prev_s;
        pd2 = prev_g;
      }
      const float t2 = secant(pd2, d2);
      s_star = __fadd_rn(slo, __fmul_rn(static_cast<float>(step), t2));
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) c[ch] = mix_rn(clo[ch], chi[ch], t2);
    }
    found[o] = 1.0f;
    invz_star[o] = mix_rn(iz0, iz1, s_star);
    rgba_star[o] = make_float4(c[0], c[1], c[2], c[3]);
  }  // tiles
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch,
// or cudaErrorInvalidValue for an empty ladder. tw (the
// band width of the bounds cells, dividing out_w) locates each lane's
// cell; r8/r32 are row_skip_tables' cells.
extern "C" int lif_lateral_march(
    const void* src, const void* ix, const void* fx, const void* izt,
    const void* klo, const void* khi, const void* r8, const void* r32,
    void* found, void* invz_star, void* rgba_star, int B, int K, int H,
    int W, int out_w, int pad_lo_x, int tw, int n_hc, int n8, int n32,
    float izmin, float izmax, int refine, void* stream) {
  if (K < 1 || refine < 0 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBlockX, kBlockY);
  const int span = kBlockX * kTiles;
  const dim3 grid((out_w + span - 1) / span, (H + kBlockY - 1) / kBlockY, B);
  auto kernel = K > kMaxPlanes ? lateral_march_kernel<true>
                               : lateral_march_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int*>(ix),
      static_cast<const float*>(fx), static_cast<const float*>(izt),
      static_cast<const int*>(klo), static_cast<const int*>(khi),
      static_cast<const float*>(r8), static_cast<const float*>(r32),
      static_cast<float*>(found), static_cast<float*>(invz_star),
      static_cast<float4*>(rgba_star), K, H, W, out_w, pad_lo_x, tw, n_hc,
      n8, n32, izmin, izmax, refine);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The lateral epilogue: what follows the march for one layer of a pose
// chunk, written into the call's output.
//
// Replaces no TPU kernel: lif_tpu leaves this stage to XLA's fusion
// (render_translation_xla's hit test and blend). In the port it was about 45
// PyTorch operators over (B, H, W) planes (ops/sweep_march.py::_finalize's
// hit test, edge taper, mask and premultiply over a zero background, the
// LDI over-compositing of models/renderer.py::_fast_batch_core,
// ops/composite.py::finish_over_background's blend and sRGB) and three
// full-frame copies (two channel concatenations and the pose chunks'
// concatenation). One thread finishes one pixel of the true width: it
// reads the march's found, invz* and rgba* (24 bytes), the layers in
// front of this one from the output (16 bytes, every layer but the first)
// and writes 16 bytes once, into the caller's (B, H, W_true, 4) frames;
// the march's width-pad columns are neither read nor written.
//
// Bound on the H100: bytes, 40 a pixel for a one-layer call (56 a pixel
// for each layer behind the first) at 3.35 TB/s; its few dozen float
// operations a pixel are far below the operation bound. Loads and the
// store are coalesced, the colour ones 16 bytes a thread.
//
// Arithmetic: the float32 operations of those PyTorch operators, in their
// order, each an explicitly rounded intrinsic (and the library is built
// with --fmad=false), with PyTorch's CUDA semantics: a division by a
// Python number is the product with the number's float32 reciprocal,
// taken on the host; each Python constant is a double rounded to float;
// clamps pass NaN through; the zero-background blend of each layer is
// kept (it turns -0 into +0). The hit test and the finish are
// csrc/epilogue.cuh's, which the stereo epilogue shares. The plain version
// is lif_tpu_torch/ops/cuda/sweep_march.py::lateral_epilogue_plain.

namespace {

constexpr int kEpilogueThreads = 256;

using lif_epilogue::HitGeom;
using lif_epilogue::Taper;

struct EpiloguePlan {
  HitGeom geom;
  Taper taper;
  float bg[4];    // the background, unless given on the device
  int mask_mode;  // 0 none, 1 multiply, 2 hard
  int to_srgb, first, last;
};

__global__ void __launch_bounds__(kEpilogueThreads) lateral_epilogue_kernel(
    const float* __restrict__ found,  // (B, H, W) 0/1
    const float* __restrict__ invz,   // (B, H, W) invz*
    const float4* __restrict__ rgba,  // (B, H, W) rgba*
    const float* __restrict__ c1,     // (B, 3) the poses
    const float* __restrict__ bgp,    // (4,) the background, or null
    float4* __restrict__ out,         // (B, H, Wt) premultiplied rgb, alpha
    long long n, int H, int W, int Wt, EpiloguePlan p) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n) return;
  const int j = static_cast<int>(q % Wt);
  const long long r = q / Wt;  // b * H + i
  const int i = static_cast<int>(r % H);
  const int b = static_cast<int>(r / H);
  const long long s = r * W + j;
  const float4 c = rgba[s];

  // _finalize's hit test at the true source position (hit_and_alpha)
  float hit;
  const float alpha = lif_epilogue::hit_alpha(
      p.geom, p.taper, p.mask_mode, c1[3 * b], c1[3 * b + 1], i, j,
      found[s], invz[s], c.w, &hit);
  // premultiplied over the zero background: 0 * 0 * (1 - alpha) + rgb * alpha
  const float z = __fmul_rn(__fmul_rn(0.0f, 0.0f), __fsub_rn(1.0f, alpha));
  float rgb[3] = {__fadd_rn(z, __fmul_rn(c.x, alpha)),
                  __fadd_rn(z, __fmul_rn(c.y, alpha)),
                  __fadd_rn(z, __fmul_rn(c.z, alpha))};
  float a = __fadd_rn(0.0f, __fmul_rn(alpha, __fsub_rn(1.0f, 0.0f)));

  // front-to-back over the layers in front (_fast_batch_core)
  if (!p.first) {
    const float4 acc = out[q];
    const float t = __fsub_rn(1.0f, acc.w);
    rgb[0] = __fadd_rn(acc.x, __fmul_rn(t, rgb[0]));
    rgb[1] = __fadd_rn(acc.y, __fmul_rn(t, rgb[1]));
    rgb[2] = __fadd_rn(acc.z, __fmul_rn(t, rgb[2]));
    a = __fadd_rn(acc.w, __fmul_rn(t, a));
  }
  if (p.last) {
    float bg[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) bg[ch] = bgp ? bgp[ch] : p.bg[ch];
    lif_epilogue::finish_rn(rgb, a, bg, p.to_srgb != 0);
  }
  out[q] = make_float4(rgb[0], rgb[1], rgb[2], a);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch, or
// cudaErrorInvalidValue for an empty or ill-shaped call. W is the march's
// (padded) width, Wt <= W the true width of `out`; the doubles are the
// Python numbers the PyTorch chain takes (feather = max(feathering, 1e-6),
// e0 = 1 - feather, e_span = 1 - e0), rounded here as PyTorch rounds them.
extern "C" int lif_lateral_epilogue(
    const void* found, const void* invz, const void* rgba, const void* c1,
    const void* bg_ptr, void* out, int B, int H, int W, int Wt, double f1,
    double bx, double by, double off_x, double off_y, int crop_y, int src_w,
    int src_h_total, double feather, double e0, double e_span, float bg0,
    float bg1, float bg2, float bg3, int mask_mode, int to_srgb, int first,
    int last, void* stream) {
  if (B < 1 || H < 1 || Wt < 1 || Wt > W || mask_mode < 0 || mask_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EpiloguePlan p;
  p.geom.f1 = static_cast<float>(f1);
  p.geom.bx = static_cast<float>(bx);
  p.geom.by = static_cast<float>(by);
  p.geom.off_x = static_cast<float>(off_x);
  p.geom.off_y = static_cast<float>(off_y);
  p.geom.crop_y = static_cast<float>(crop_y);
  p.geom.inv_src_w = 1.0f / static_cast<float>(src_w);
  p.geom.inv_src_h = 1.0f / static_cast<float>(src_h_total);
  p.taper.inv_f = 1.0f / static_cast<float>(feather);
  p.taper.e0 = static_cast<float>(e0);
  p.taper.inv_e = 1.0f / static_cast<float>(e_span);
  p.bg[0] = bg0;
  p.bg[1] = bg1;
  p.bg[2] = bg2;
  p.bg[3] = bg3;
  p.mask_mode = mask_mode;
  p.to_srgb = to_srgb;
  p.first = first;
  p.last = last;
  const long long n = static_cast<long long>(B) * H * Wt;
  const unsigned blocks =
      static_cast<unsigned>((n + kEpilogueThreads - 1) / kEpilogueThreads);
  lateral_epilogue_kernel<<<blocks, kEpilogueThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(found), static_cast<const float*>(invz),
      static_cast<const float4*>(rgba), static_cast<const float*>(c1),
      static_cast<const float*>(bg_ptr), static_cast<float4*>(out), n, H, W,
      Wt, p);
  return static_cast<int>(cudaGetLastError());
}
