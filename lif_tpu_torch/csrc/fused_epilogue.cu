// The fused epilogue: what follows the lateral marches of every projector
// and layer of one pose chunk of multi-projector fusion, written into the
// call's output, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: lif_tpu leaves this stage to XLA's fusion
// (render_fused_fast_batch's composite and merge). In the port it was
// models/renderer.py::_fused_fast_core's chain of PyTorch operators over
// (B, H, W) planes: for each projector and layer ops/sweep_march.py's
// _finalize(raw=True) (hit test at the true source position,
// composite.edge_alpha's taper and mask), the front-to-back over and the
// front hit's inverse depth; the stack of the projectors;
// ops/composite.py::fuse_views (the frontmost key, fusion_weights'
// triangular weights, the weighted colour and alpha); and
// finish_over_background's blend and sRGB with its channel concatenation.
// One thread finishes one output pixel of one pose: it reads each entry's
// found, invz* and rgba* (24 bytes an entry), composites each projector's
// layers front to back, merges the projectors and writes 16 bytes once,
// into the caller's (B, H, W_true, 4) frames; the marches' width-pad
// columns are neither read nor written. Any number of projectors and
// layers: the first kInline entries ride in the kernel's parameters (no
// upload), any further ones in a device table the wrapper uploads with
// the launch (pinned, on the stream, no wait); the merge takes two passes
// over the projectors, the first for the frontmost surface, the second
// for the weighted sums; the first kCache projectors' composites stay in
// registers between them, the others are composited again in the second
// pass from the same reads.
//
// Bound on the H100: bytes, 24 a projector layer and 16 written a pixel
// (112 at four one-layer projectors) at 3.35 TB/s (projectors past kCache
// are read twice); its operations (about 60 an entry, 40 a projector of
// the merge, 3 powf) are far below the operation bound. Loads and the
// store are coalesced, the colour ones 16 bytes a thread; the entries are
// read alike by every thread, from the constant bank (or, past kInline,
// as a broadcast from L1).
//
// Arithmetic: the float32 operations of those PyTorch operators, in their
// order, each an explicitly rounded intrinsic (and the library is built
// with --fmad=false), with PyTorch's CUDA semantics: a division by a
// tensor is a true division; a division by a Python number is the product
// with the number's float32 reciprocal, taken on the host; each Python
// constant is a double rounded to float; clamps and amax pass NaN through;
// a sum over the projector axis adds as PyTorch's reduction does, in four
// interleaved partial sums from zero (projector v into sum v mod 4), then
// those four in order, which for up to four projectors is 0 + w0 + w1 +
// ... in order. The hit test and the finish are the lateral epilogue's
// (csrc/sweep_march.cu, lif_lateral_epilogue). The plain version is
// lif_tpu_torch/ops/cuda/fused_epilogue.py::fused_epilogue_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// projectors kept in registers between the passes: at 4 the kernel takes
// 64 registers a thread, at 8 it took 80 and ran 18% longer at four
// projectors (fewer resident blocks)
constexpr int kCache = 4;
constexpr int kInline = 32;  // entries in the kernel's parameters
static_assert(kCache % 4 == 0, "the second pass adds four projectors a step");

// One projector layer; the wrapper's table record (_ENTRY, 72 bytes).
struct Entry {
  const float* found;   // (B, H, W) 0/1
  const float* invz;    // (B, H, W) invz*
  const float4* rgba;   // (B, H, W) rgba*
  const float* c1;      // (B, 3) the projector's poses of the chunk
  int w;                // the march's (padded) width W
  int flags;            // mask mode (0 none, 1 multiply, 2 hard) | 4: the
                        // projector's last layer
  float f1, bx, by, off_x, off_y, crop_y;
  float inv_src_w, inv_src_h;  // 1 / src_w, 1 / (src_h + 2 crop_y)
};
static_assert(sizeof(Entry) == 72, "the wrapper's record is 72 bytes");

struct Params {
  Entry e[kInline];     // the first entries: projector by projector, each
                        // projector's layers front to back
  const Entry* far;     // entry kInline + k at far[k] (device), or null
  int n_views;
  int hard;             // fuse_tol <= 0: the nearest wins
  float tol;            // fuse_tol
  float inv_f;          // smoothstep(0, f): 1 / f
  float e0, inv_e;      // smoothstep(1 - f, 1): 1 - f, its 1 / width
  float bg[4];          // the background, unless given on the device
  int to_srgb;
};

// One projector's composite at an output pixel: premultiplied colour,
// alpha and the front hit's inverse depth.
struct View {
  float r, g, b, a, front;
};

// clamp(x, lo, hi) as PyTorch's CUDA clamp: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.clamp(x, min=lo)
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// GLSL smoothstep(e0, e1, x), inv = 1 / (e1 - e0): t * t * (3 - 2 t)
__device__ __forceinline__ float smoothstep_rn(float x, float e0, float inv) {
  const float t = clamp_nan(__fmul_rn(__fsub_rn(x, e0), inv), 0.0f, 1.0f);
  return __fmul_rn(__fmul_rn(t, t), __fsub_rn(3.0f, __fmul_rn(2.0f, t)));
}

// core/color.py::linear_to_srgb
__device__ __forceinline__ float srgb_rn(float x) {
  if (x <= static_cast<float>(0.0031308)) {
    return __fmul_rn(x, static_cast<float>(12.92));
  }
  const float b = isnan(x) ? x : fmaxf(x, static_cast<float>(1e-12));
  return __fsub_rn(
      __fmul_rn(powf(b, static_cast<float>(1.0 / 2.4)),
                static_cast<float>(1.055)),
      static_cast<float>(0.055));
}

// _finalize(raw=True)'s alpha for one layer at output pixel (i, j) of pose
// b: the hit test at the true source position and edge_alpha
__device__ __forceinline__ float layer_alpha(const Entry& e, int b, int i,
                                             int j, float fnd, float iz,
                                             float mask, const Params& p) {
  const float sx = __fmul_rn(e.c1[3 * b], e.f1);
  const float sy = __fmul_rn(e.c1[3 * b + 1], e.f1);
  const float gx = __fadd_rn(
      __fsub_rn(__fadd_rn(static_cast<float>(j), e.bx), __fmul_rn(sx, iz)),
      e.off_x);
  const float gy = __fadd_rn(
      __fsub_rn(__fadd_rn(static_cast<float>(i), e.by), __fmul_rn(sy, iz)),
      e.off_y);
  const float u = __fmul_rn(__fadd_rn(gx, 0.5f), e.inv_src_w);
  const float v = __fmul_rn(__fadd_rn(__fadd_rn(gy, e.crop_y), 0.5f),
                            e.inv_src_h);
  const float inside =
      (u > 0.0f && u < 1.0f && v > 0.0f && v < 1.0f) ? 1.0f : 0.0f;
  const float tap = __fmul_rn(
      __fmul_rn(__fmul_rn(smoothstep_rn(u, 0.0f, p.inv_f),
                          __fsub_rn(1.0f, smoothstep_rn(u, p.e0, p.inv_e))),
                smoothstep_rn(v, 0.0f, p.inv_f)),
      __fsub_rn(1.0f, smoothstep_rn(v, p.e0, p.inv_e)));
  float alpha = __fmul_rn(__fmul_rn(fnd, inside), tap);
  const int mask_mode = e.flags & 3;
  if (mask_mode == 1) {
    alpha = __fmul_rn(alpha, clamp_nan(mask, 0.0f, 1.0f));
  } else if (mask_mode == 2) {
    alpha = __fmul_rn(alpha, mask >= 0.5f ? 1.0f : 0.0f);
  }
  return alpha;
}

// one layer over a projector's composite so far (_fused_fast_core's over)
__device__ __forceinline__ bool over(View& o, const Entry& e, bool first,
                                     long long r, int b, int i, int j,
                                     const Params& p) {
  const long long s = r * e.w + j;
  const float iz = e.invz[s];
  const float4 c = e.rgba[s];
  const float alpha = layer_alpha(e, b, i, j, e.found[s], iz, c.w, p);
  if (first) {
    o.r = __fmul_rn(alpha, c.x);
    o.g = __fmul_rn(alpha, c.y);
    o.b = __fmul_rn(alpha, c.z);
    o.a = alpha;
    o.front = alpha > 0.0f ? iz : 0.0f;
  } else {
    const float m = __fmul_rn(__fsub_rn(1.0f, o.a), alpha);
    o.r = __fadd_rn(o.r, __fmul_rn(m, c.x));
    o.g = __fadd_rn(o.g, __fmul_rn(m, c.y));
    o.b = __fadd_rn(o.b, __fmul_rn(m, c.z));
    if (alpha > 0.0f && o.front == 0.0f) o.front = iz;
    o.a = __fadd_rn(o.a, m);
  }
  return (e.flags & 4) != 0;
}

// the composite of the projector whose layers start at entry k, front to
// back, at output pixel (i, j) of pose b (r = b * H + i); k moves past them
__device__ __forceinline__ View composite(const Params& p, int& k,
                                          long long r, int b, int i, int j) {
  View o{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  bool last = false;
  for (bool first = true; !last; first = false, ++k) {
    last = k < kInline ? over(o, p.e[k], first, r, b, i, j, p)
                       : over(o, p.far[k - kInline], first, r, b, i, j, p);
  }
  return o;
}

// fuse_views' key: the front hit's inverse depth where the projector hits
__device__ __forceinline__ float view_key(const View& o) {
  return o.a > 0.0f ? o.front : -INFINITY;
}

// amax over the projector axis, one more key (NaN passes through)
__device__ __forceinline__ float max_nan(float best, float key) {
  if (isnan(best)) return best;
  return isnan(key) ? key : fmaxf(best, key);
}

// The merge's sums over the projector axis as PyTorch's CUDA sum over a
// leading axis adds them: four accumulators from zero, projector v into
// accumulator v mod 4, then combined in order.
struct Sums {
  float w[4], r[4], g[4], b[4], a[4];

  __device__ __forceinline__ void add(int u, const View& o, float best,
                                      float edge, const Params& p) {
    const float key = view_key(o);
    const bool hit = o.a > 0.0f;
    float wt;
    if (p.hard) {
      wt = (hit && key >= best) ? 1.0f : 0.0f;
    } else {
      const float t = __fsub_rn(1.0f, __fdiv_rn(__fsub_rn(best, key), edge));
      const float tw = isfinite(key) ? clamp_nan(t, 0.0f, 1.0f) : 0.0f;
      wt = hit ? tw : 0.0f;
    }
    w[u] = __fadd_rn(w[u], wt);
    r[u] = __fadd_rn(r[u], __fmul_rn(wt, o.r));
    g[u] = __fadd_rn(g[u], __fmul_rn(wt, o.g));
    b[u] = __fadd_rn(b[u], __fmul_rn(wt, o.b));
    a[u] = __fadd_rn(a[u], __fmul_rn(wt, o.a));
  }
};

__device__ __forceinline__ float total(const float (&x)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(x[0], x[1]), x[2]), x[3]);
}

__global__ void __launch_bounds__(kThreads) fused_epilogue_kernel(
    const float* __restrict__ bgp,  // (4,) the background, or null
    float4* __restrict__ out,       // (B, H, Wt) the finished frames
    long long n, int H, int Wt, const __grid_constant__ Params p) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (q >= n) return;
  const int j = static_cast<int>(q % Wt);
  const long long r = q / Wt;  // b * H + i
  const int i = static_cast<int>(r % H);
  const int b = static_cast<int>(r / H);
  const int V = p.n_views;

  // first pass: each projector's composite, the frontmost key
  View cache[kCache];
  float best = -INFINITY;
  int k = 0;
#pragma unroll
  for (int v = 0; v < kCache; ++v) {
    if (v < V) {
      cache[v] = composite(p, k, r, b, i, j);
      best = max_nan(best, view_key(cache[v]));
    }
  }
  const int k_rest = k;  // the first entry of projector kCache
  for (int v = kCache; v < V; ++v) {
    best = max_nan(best, view_key(composite(p, k, r, b, i, j)));
  }

  // second pass: the weights and the weighted sums (fuse_views)
  const float edge = clamp_min_nan(__fmul_rn(fabsf(best), p.tol), 1e-30f);
  Sums s = {};
#pragma unroll
  for (int v = 0; v < kCache; ++v) {
    if (v < V) s.add(v % 4, cache[v], best, edge, p);
  }
  k = k_rest;
  for (int v0 = kCache; v0 < V; v0 += 4) {  // kCache is a multiple of 4
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (v0 + u < V) s.add(u, composite(p, k, r, b, i, j), best, edge, p);
    }
  }
  const float wsum = clamp_min_nan(total(s.w), 1e-12f);
  float out_rgb[3] = {__fdiv_rn(total(s.r), wsum),
                      __fdiv_rn(total(s.g), wsum),
                      __fdiv_rn(total(s.b), wsum)};
  float alpha = __fdiv_rn(total(s.a), wsum);
  if (!isfinite(best)) alpha = 0.0f;

  // finish_over_background
  float bg[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) bg[ch] = bgp ? bgp[ch] : p.bg[ch];
  const float t = __fsub_rn(1.0f, alpha);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    out_rgb[ch] =
        __fadd_rn(__fmul_rn(__fmul_rn(bg[ch], bg[3]), t), out_rgb[ch]);
    if (p.to_srgb) out_rgb[ch] = srgb_rn(out_rgb[ch]);
  }
  alpha = __fadd_rn(bg[3], __fmul_rn(alpha, __fsub_rn(1.0f, bg[3])));
  out[q] = make_float4(out_rgb[0], out_rgb[1], out_rgb[2], alpha);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch, or
// cudaErrorInvalidValue for an empty or ill-shaped call. table: on the
// host, the n_entries 72-byte entry records of the wrapper's _entry_table
// (projector by projector, front to back within each, the last layer of
// each flagged), of which the first kInline are copied into the launch's
// parameters; far: the records past kInline on the device (null for at
// most kInline). The wrapper has checked each entry. feather, e0 and
// e_span are the edge taper's numbers (max(feathering, 1e-6), 1 - f,
// 1 - (1 - f)); hard is fuse_tol <= 0, decided on the host's double.
extern "C" int lif_fused_epilogue(
    const void* table, const void* far, int n_entries, int V,
    const void* bg_ptr, void* out, int B, int H, int Wt, double tol,
    int hard, double feather, double e0, double e_span, float bg0, float bg1,
    float bg2, float bg3, int to_srgb, void* stream) {
  if (table == nullptr || B < 1 || H < 1 || Wt < 1 || V < 1 ||
      n_entries < V || (n_entries > kInline && far == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  const Entry* host = static_cast<const Entry*>(table);
  for (int k = 0; k < kInline; ++k) p.e[k] = k < n_entries ? host[k] : Entry{};
  p.far = static_cast<const Entry*>(far);
  p.n_views = V;
  p.hard = hard;
  p.tol = static_cast<float>(tol);
  p.inv_f = 1.0f / static_cast<float>(feather);
  p.e0 = static_cast<float>(e0);
  p.inv_e = 1.0f / static_cast<float>(e_span);
  p.bg[0] = bg0;
  p.bg[1] = bg1;
  p.bg[2] = bg2;
  p.bg[3] = bg3;
  p.to_srgb = to_srgb;
  const long long n = static_cast<long long>(B) * H * Wt;
  const unsigned blocks =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  fused_epilogue_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bg_ptr), static_cast<float4*>(out), n, H, Wt,
      p);
  return static_cast<int>(cudaGetLastError());
}
