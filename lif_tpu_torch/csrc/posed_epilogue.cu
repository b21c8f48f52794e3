// The target and scaled epilogue: what follows the depth-only march of
// one layer of a pose chunk on the orbit ('target') and zoom ('scaled')
// tiers, written into the call's output, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: lif_tpu leaves this stage to XLA's fusion
// (render_target_xla's and render_scaled_xla's fetch and finalize). In the
// port it was about 60 PyTorch operators over (B, H, W) planes: the tier's
// solved source position (ops/sweep_target.py::_solved_uv, with _fields'
// per-pixel homography; ops/sweep_scaled.py::_solved_uv), the packed
// bilinear fetch there (ops/sampling.py::bilinear_sample_packed: four
// corners, each unpacked by a stack), composite.edge_alpha, the premultiply
// over a zero background, the LDI over-compositing of
// models/renderer.py::_fast_batch_core and finish_over_background's blend
// and sRGB, with a channel concatenation in each finish and the pose
// chunks' concatenation. One thread finishes one pixel of the true width:
// it reads the march's found and invz* (8 bytes), its tier's pose row, four
// texels of the pack_rgbm source (4 MB at 1280x800, held in L2 across the
// chunk), the layers in front of this one from the output (16 bytes, every
// layer but the first) and writes 16 bytes once, into the caller's
// (B, H, W_true, 4) frames; the march's width-pad columns are neither read
// nor written. A block finishes one output row, so the pose row is one
// broadcast load, and first tables the 1024 quotients k / 1023 of the
// 10-bit unpack (the same rounded divisions, four a thread where the
// fetch would take twelve a pixel).
//
// Bound on the H100: bytes, 24 a pixel for a one-layer call (40 a pixel
// for each layer behind the first) at 3.35 TB/s, 0.0073 ms a 1280x800
// frame. Loads and the store are coalesced, the colour store 16 bytes a
// thread. It runs at about a third of that bound (0.020-0.023 ms a frame
// on an H100 SXM at 700 W): the instructions of its exactly rounded
// divisions (target six a pixel, scaled two) and of sRGB's three powf,
// which the bit-for-bit contract keeps, set its pace.
//
// Arithmetic: the float32 operations of those PyTorch operators, in their
// order, each an explicitly rounded intrinsic (and the library is built
// with --fmad=false), with PyTorch's CUDA semantics: a division by a
// tensor is a true division; a division by a Python number is the product
// with the number's float32 reciprocal, taken on the host; each Python
// constant is a double rounded to float; a float turns into an index as
// PyTorch's int64 cast turns it; clamps pass NaN through; the
// zero-background blend of each layer is kept (it turns -0 into +0). The
// finish is the lateral epilogue's (csrc/sweep_march.cu,
// lif_lateral_epilogue). The plain version is
// lif_tpu_torch/ops/cuda/posed_epilogue.py::posed_epilogue_plain.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTarget = 0;
constexpr int kScaled = 1;

struct Plan {
  // the uv solve: u = (...) / nu, v = (...) / nv
  float nu, nv;
  // target: _fields' pixel grid and the invz* range it clamps to
  float out_w, out_h, izmin, izmax;
  // scaled: f1, fr, the source's centring offsets, the frustum shift, the
  // centre pixel and the outpaint crop
  float f1, fr, bx, by, dxu, dyu, cx0, cy0, crop_y;
  // the packed texture's size
  int tex_w, tex_h;
  // the finish (as lif_lateral_epilogue's)
  float inv_f;       // smoothstep(0, f): 1 / f
  float e0, inv_e;   // smoothstep(1 - f, 1): 1 - f, its 1 / width
  float bg[4];       // the background, unless given on the device
  int mask_mode;     // 0 none, 1 multiply, 2 hard
  int to_srgb, first, last;
};

// clamp(x, lo, hi) as PyTorch's CUDA clamp: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ long long clamp_index(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
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

// ops/sweep_target.py::_solved_uv for pixel (i, j) of the pose pack p
// (target_pose_scalars: row-major p_ts, then c_vec)
__device__ __forceinline__ void target_uv(const float* __restrict__ p,
                                          float iz, int i, int j,
                                          const Plan& q, float& u, float& v) {
  // _fields: the pixel's normalised target position, its homography
  const float sx = __fsub_rn(
      __fdiv_rn(__fadd_rn(static_cast<float>(j), 0.5f), q.out_w), 0.5f);
  const float sy = __fsub_rn(
      __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f), q.out_h), 0.5f);
  const float den =
      __fadd_rn(__fadd_rn(__fmul_rn(p[6], sx), __fmul_rn(p[7], sy)), p[8]);
  const float qx = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p[0], sx), __fmul_rn(p[1], sy)), p[2]),
      den);
  const float qy = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(p[3], sx), __fmul_rn(p[4], sy)), p[5]),
      den);
  const float ax = __fsub_rn(__fmul_rn(__fadd_rn(qx, 0.5f), q.nu), 0.5f);
  const float ay = __fsub_rn(__fmul_rn(__fadd_rn(qy, 0.5f), q.nv), 0.5f);
  const float dx = __fmul_rn(__fsub_rn(p[9], __fmul_rn(p[11], qx)), q.nu);
  const float dy = __fmul_rn(__fsub_rn(p[10], __fmul_rn(p[11], qy)), q.nv);
  // the solved position at invz* clipped to the range
  const float vz = clamp_nan(iz, q.izmax, q.izmin);
  u = __fdiv_rn(__fadd_rn(__fadd_rn(ax, __fmul_rn(vz, dx)), 0.5f), q.nu);
  v = __fdiv_rn(__fadd_rn(__fadd_rn(ay, __fmul_rn(vz, dy)), 0.5f), q.nv);
}

// ops/sweep_scaled.py::_solved_uv for pixel (i, j) of the pose c (c1);
// iz is invz* where found, else 0
__device__ __forceinline__ void scaled_uv(const float* __restrict__ c,
                                          float iz, int i, int j,
                                          const Plan& q, float& u, float& v) {
  const float xf = static_cast<float>(j);
  const float yf = static_cast<float>(i);
  const float f1cx = __fmul_rn(c[0], q.f1);
  const float f1cy = __fmul_rn(c[1], q.f1);
  const float e =
      __fsub_rn(__fmul_rn(q.fr, __fadd_rn(__fmul_rn(c[2], iz), 1.0f)), 1.0f);
  const float gx = __fadd_rn(
      __fsub_rn(__fadd_rn(__fadd_rn(xf, q.bx), q.dxu), __fmul_rn(f1cx, iz)),
      __fmul_rn(e, __fsub_rn(xf, q.cx0)));
  const float gy = __fadd_rn(
      __fsub_rn(__fadd_rn(__fadd_rn(yf, q.by), q.dyu),
                __fmul_rn(f1cy, iz)),
      __fmul_rn(e, __fsub_rn(yf, q.cy0)));
  u = __fdiv_rn(__fadd_rn(gx, 0.5f), q.nu);
  v = __fdiv_rn(__fadd_rn(__fadd_rn(gy, q.crop_y), 0.5f), q.nv);
}

// ops/sampling.py::_unpack_rgbm: 10-bit colour by true division (the
// block's table of k / 1023), the mask bit
__device__ __forceinline__ float4 unpack_rgbm(int t,
                                              const float* __restrict__ unit) {
  return make_float4(unit[(t >> 21) & 1023], unit[(t >> 11) & 1023],
                     unit[(t >> 1) & 1023], static_cast<float>(t & 1));
}

// a + (b - a) * f, channel by channel
__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  return make_float4(__fadd_rn(a.x, __fmul_rn(__fsub_rn(b.x, a.x), f)),
                     __fadd_rn(a.y, __fmul_rn(__fsub_rn(b.y, a.y), f)),
                     __fadd_rn(a.z, __fmul_rn(__fsub_rn(b.z, a.z), f)),
                     __fadd_rn(a.w, __fmul_rn(__fsub_rn(b.w, a.w), f)));
}

// ops/sampling.py::bilinear_sample_packed at (u, v): [r, g, b, mask]
__device__ __forceinline__ float4 fetch_packed(const int* __restrict__ tex,
                                               const float* __restrict__ unit,
                                               float u, float v,
                                               const Plan& q) {
  const float sx = __fsub_rn(__fmul_rn(u, static_cast<float>(q.tex_w)), 0.5f);
  const float sy = __fsub_rn(__fmul_rn(v, static_cast<float>(q.tex_h)), 0.5f);
  const float flx = floorf(sx);
  const float fly = floorf(sy);
  const long long x0 = static_cast<long long>(flx);
  const long long y0 = static_cast<long long>(fly);
  const long long wmax = q.tex_w - 1;
  const long long hmax = q.tex_h - 1;
  // _edge_weights: no lerp where clamping collapses both taps
  const float fx = (x0 >= 0 && x0 < wmax) ? __fsub_rn(sx, flx) : 0.0f;
  const float fy = (y0 >= 0 && y0 < hmax) ? __fsub_rn(sy, fly) : 0.0f;
  // x0 + 1 wraps as PyTorch's int64 add does
  const long long x1 = static_cast<long long>(
      static_cast<unsigned long long>(x0) + 1ull);
  const long long y1 = static_cast<long long>(
      static_cast<unsigned long long>(y0) + 1ull);
  const long long ix0 = clamp_index(x0, wmax);
  const long long ix1 = clamp_index(x1, wmax);
  const long long r0 = clamp_index(y0, hmax) * q.tex_w;
  const long long r1 = clamp_index(y1, hmax) * q.tex_w;
  const float4 top = lerp4(unpack_rgbm(tex[r0 + ix0], unit),
                           unpack_rgbm(tex[r0 + ix1], unit), fx);
  const float4 bot = lerp4(unpack_rgbm(tex[r1 + ix0], unit),
                           unpack_rgbm(tex[r1 + ix1], unit), fx);
  return lerp4(top, bot, fy);
}

// One block finishes one output row (b, i); its threads walk the row's
// true width kThreads columns apart
template <int kTier>
__global__ void __launch_bounds__(kThreads) posed_epilogue_kernel(
    const float* __restrict__ found,  // (B, H, W) 0/1
    const float* __restrict__ invz,   // (B, H, W) invz*
    const float* __restrict__ poses,  // (B, 16) target packs or (B, 3) c1
    const int* __restrict__ tex,      // (tex_h, tex_w) pack_rgbm
    const float* __restrict__ bgp,    // (4,) the background, or null
    float4* __restrict__ out,         // (B, H, Wt) premultiplied rgb, alpha
    int H, int W, int Wt, Plan p) {
  __shared__ float unit[1024];  // k / 1023 by true division
  for (int k = threadIdx.x; k < 1024; k += kThreads) {
    unit[k] = __fdiv_rn(static_cast<float>(k), 1023.0f);
  }
  __syncthreads();
  const unsigned r = blockIdx.x;  // b * H + i
  const int i = static_cast<int>(r % H);
  const int b = static_cast<int>(r / H);
  for (int j = threadIdx.x; j < Wt; j += kThreads) {
    const long long s = static_cast<long long>(r) * W + j;
    const long long q = static_cast<long long>(r) * Wt + j;
    const float fd = found[s];
    float u, v;
    if (kTier == kTarget) {
      target_uv(poses + 16 * b, invz[s], i, j, p, u, v);
    } else {
      scaled_uv(poses + 3 * b, fd > 0.5f ? invz[s] : 0.0f, i, j, p, u, v);
    }
    const float4 c = fetch_packed(tex, unit, u, v, p);

    // composite.edge_alpha
    const float inside =
        (u > 0.0f && u < 1.0f && v > 0.0f && v < 1.0f) ? 1.0f : 0.0f;
    const float tap = __fmul_rn(
        __fmul_rn(__fmul_rn(smoothstep_rn(u, 0.0f, p.inv_f),
                            __fsub_rn(1.0f, smoothstep_rn(u, p.e0, p.inv_e))),
                  smoothstep_rn(v, 0.0f, p.inv_f)),
        __fsub_rn(1.0f, smoothstep_rn(v, p.e0, p.inv_e)));
    float alpha = __fmul_rn(__fmul_rn(fd, inside), tap);
    if (p.mask_mode == 1) {
      alpha = __fmul_rn(alpha, clamp_nan(c.w, 0.0f, 1.0f));
    } else if (p.mask_mode == 2) {
      alpha = __fmul_rn(alpha, c.w >= 0.5f ? 1.0f : 0.0f);
    }
    // premultiplied over the zero background:
    // 0 * 0 * (1 - alpha) + rgb * alpha
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
    // finish_over_background
    if (p.last) {
      float bg[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) bg[ch] = bgp ? bgp[ch] : p.bg[ch];
      const float t = __fsub_rn(1.0f, a);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        rgb[ch] = __fadd_rn(__fmul_rn(__fmul_rn(bg[ch], bg[3]), t), rgb[ch]);
        if (p.to_srgb) rgb[ch] = srgb_rn(rgb[ch]);
      }
      a = __fadd_rn(bg[3], __fmul_rn(a, __fsub_rn(1.0f, bg[3])));
    }
    out[q] = make_float4(rgb[0], rgb[1], rgb[2], a);
  }
}

}  // namespace

// Launch the epilogue of tier 0 (target) or 1 (scaled) on `stream`; returns
// cudaGetLastError() right after the launch, or cudaErrorInvalidValue for
// an empty or ill-shaped call. W is the march's (padded) width, Wt <= W the
// true width of `out`. geom holds the Python numbers of the tier's uv
// solve, rounded here as PyTorch rounds them: [u divisor, v divisor,
// target grid width, its height, izmin, izmax, f1, fr, bx, by, dx_user,
// dy_user, cx0, cy0, crop_y] (a tier reads its own). feather, e0 and
// e_span are the edge taper's numbers (max(feathering, 1e-6), 1 - f,
// 1 - (1 - f)).
extern "C" int lif_posed_epilogue(
    int tier, const void* found, const void* invz, const void* poses,
    const void* tex, const void* bg_ptr, void* out, int B, int H, int W,
    int Wt, int tex_w, int tex_h, const double* geom, double feather,
    double e0, double e_span, float bg0, float bg1, float bg2, float bg3,
    int mask_mode, int to_srgb, int first, int last, void* stream) {
  if (B < 1 || H < 1 || Wt < 1 || Wt > W || tex_w < 1 || tex_h < 1 ||
      mask_mode < 0 || mask_mode > 2 || (tier != kTarget && tier != kScaled)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  float g[15];
  for (int k = 0; k < 15; ++k) g[k] = static_cast<float>(geom[k]);
  p.nu = g[0];
  p.nv = g[1];
  p.out_w = g[2];
  p.out_h = g[3];
  p.izmin = g[4];
  p.izmax = g[5];
  p.f1 = g[6];
  p.fr = g[7];
  p.bx = g[8];
  p.by = g[9];
  p.dxu = g[10];
  p.dyu = g[11];
  p.cx0 = g[12];
  p.cy0 = g[13];
  p.crop_y = g[14];
  p.tex_w = tex_w;
  p.tex_h = tex_h;
  p.inv_f = 1.0f / static_cast<float>(feather);
  p.e0 = static_cast<float>(e0);
  p.inv_e = 1.0f / static_cast<float>(e_span);
  p.bg[0] = bg0;
  p.bg[1] = bg1;
  p.bg[2] = bg2;
  p.bg[3] = bg3;
  p.mask_mode = mask_mode;
  p.to_srgb = to_srgb;
  p.first = first;
  p.last = last;
  const long long rows = static_cast<long long>(B) * H;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(found);
  const auto* iz = static_cast<const float*>(invz);
  const auto* ps = static_cast<const float*>(poses);
  const auto* tx = static_cast<const int*>(tex);
  const auto* bg = static_cast<const float*>(bg_ptr);
  auto* o = static_cast<float4*>(out);
  if (tier == kTarget) {
    posed_epilogue_kernel<kTarget>
        <<<blocks, kThreads, 0, st>>>(f, iz, ps, tx, bg, o, H, W, Wt, p);
  } else {
    posed_epilogue_kernel<kScaled>
        <<<blocks, kThreads, 0, st>>>(f, iz, ps, tx, bg, o, H, W, Wt, p);
  }
  return static_cast<int>(cudaGetLastError());
}
