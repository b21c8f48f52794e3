// The stereo epilogue: what follows both eyes' lateral marches of one LDI
// layer of a pose chunk of render_stereo_fast_batch, written into the
// call's output, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: lif_tpu leaves this stage to XLA's fusion
// (its stereo fast core's confidence, fill and blend). In the port it was
// models/renderer.py::_stereo_core's chain of PyTorch operators over
// (B, H, W) planes, for each eye: ops/sweep_march.py's _finalize(raw=True)
// (hit test at the true source position, composite.edge_alpha's taper and
// mask) and the channel concatenation of the view; the stretch-mark
// confidence (ops/cuda/stereo_epilogue.py::stretch_conf, each ds x ds
// block's probe at its first pixel, two clamped bilinear disparity reads
// along the exact ray, nearest-upsampled); then ops/stereo.py's
// occlusion_blend (L filled from R, R from the filled L, the baseline
// blend), composite.over onto the layers in front, on the last layer
// finish_over_background's blend and sRGB, and the pose chunks'
// concatenation.
//
// Design. A block is a tile of 32 x 8 output pixels of one pose, one
// thread a pixel; a warp is 32 neighbouring columns of a row, so every
// load and the store are coalesced (the colour ones 16 bytes a thread).
// ds (4, 2 or 1) divides the tile, so each confidence block lies in one
// tile: the tile's probes (two eyes x (32 / ds) x (8 / ds) blocks) are
// spread over its threads, each taking the block's anchor invz*, the
// pose's transform (p and c_vec, computed on the host in float32 and
// uploaded with the chunk) and two bilinear reads of the eye-layer's
// disparity texture (small enough to stay in L2), and their kill flags
// are shared through shared memory. A thread then reads each eye's found,
// invz* and rgba* (24 bytes an eye), the layers in front of this one from
// the output (16 bytes, every layer but the first), and writes 16 bytes
// once, into the caller's (B, H, W, 4) frames. The stereo march has no
// width pad, so the march's width is the output's.
//
// Bound on the H100: bytes, 64 a pixel for the front layer and 80 for
// each layer behind it (48 read from the marches, 16 read and 16 written
// in the output) at 3.35 TB/s; about 80 float operations an eye and
// pixel, 3 powf on the last layer, and the probes' 90 operations an eye
// and block are far below the operation bound.
//
// Arithmetic: the float32 operations of those PyTorch operators, in their
// order, each an explicitly rounded intrinsic (and the library is built
// with --fmad=false), with PyTorch's CUDA semantics: a division by a
// tensor is a true division; a division by a Python number is the product
// with the number's float32 reciprocal, taken on the host; each Python
// constant is a double rounded to float; clamps pass NaN through. The hit
// test and the finish are csrc/epilogue.cuh's, shared with the lateral
// epilogue. The plain version is
// lif_tpu_torch/ops/cuda/stereo_epilogue.py::stereo_epilogue_plain.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kTileW = 32;  // a warp: 32 columns of one row
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;

using lif_epilogue::HitGeom;
using lif_epilogue::Taper;
using lif_epilogue::clamp_nan;

// One eye-layer; the wrapper's record (_EYE, 144 bytes).
struct Eye {
  const float* found;   // (B, H, W) 0/1
  const float* invz;    // (B, H, W) invz*
  const float4* rgba;   // (B, H, W) rgba*
  const float* c1;      // (B, 3) the eye's poses of the chunk
  const float* tf;      // (B, 12) stretch_conf's p (3 x 3, row-major), c_vec
  const float* disp;    // (hs, ws) the layer's disparity texture
  int ws, hs, ld;       // its dims and its row stride, in floats
  int unused;
  HitGeom geom;
  float fws, fhs;       // float(ws), float(hs)
  float bu, bu_hi;      // read_disp's clamp of u: 2 / ws, 1 - 2 / ws
  float bv, bv_hi;      // and of v
  float dxp, dyp;       // the skew fold's shift over (ws, hs)
  float dv, thr;        // one production step (range / 40), 2.8 dv
  float scale, vmax;    // the decode: texel * scale + vmax
};
static_assert(sizeof(Eye) == 144, "the wrapper's record is 144 bytes");

struct Params {
  Eye eye[2];         // left, right
  const float* w_r;   // (B,) the right view's blend weight
  const float* bgp;   // (4,) the background on the device, or null
  float bg[4];        // the background, unless on the device
  Taper taper;
  int mask_mode;      // 0 none, 1 multiply, 2 hard
  int ds;             // the confidence grid's step
  float inv_w, inv_h; // 1 / W, 1 / H
  int to_srgb, first, last;
};

// ops/sampling.py::read_disp at (u, v): the 2-texel interior clamp, the
// edge-clamped bilinear read, the decode
__device__ __forceinline__ float read_disp(const Eye& e, float u, float v) {
  const float uc = clamp_nan(u, e.bu, e.bu_hi);
  const float vc = clamp_nan(v, e.bv, e.bv_hi);
  const float sx = __fsub_rn(__fmul_rn(uc, e.fws), 0.5f);
  const float sy = __fsub_rn(__fmul_rn(vc, e.fhs), 0.5f);
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  const float fx = __fsub_rn(sx, x0f);
  const float fy = __fsub_rn(sy, y0f);
  const long long x0 = static_cast<long long>(x0f);
  const long long y0 = static_cast<long long>(y0f);
  const long long wmax = e.ws - 1, hmax = e.hs - 1;
  const long long ix0 = x0 < 0 ? 0 : (x0 > wmax ? wmax : x0);
  const long long ix1 = x0 + 1 < 0 ? 0 : (x0 + 1 > wmax ? wmax : x0 + 1);
  const long long iy0 = y0 < 0 ? 0 : (y0 > hmax ? hmax : y0);
  const long long iy1 = y0 + 1 < 0 ? 0 : (y0 + 1 > hmax ? hmax : y0 + 1);
  const float t00 = __ldg(e.disp + iy0 * e.ld + ix0);
  const float t01 = __ldg(e.disp + iy0 * e.ld + ix1);
  const float t10 = __ldg(e.disp + iy1 * e.ld + ix0);
  const float t11 = __ldg(e.disp + iy1 * e.ld + ix1);
  const float top = __fadd_rn(t00, __fmul_rn(__fsub_rn(t01, t00), fx));
  const float bot = __fadd_rn(t10, __fmul_rn(__fsub_rn(t11, t10), fx));
  const float tex = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
  return __fadd_rn(__fmul_rn(tex, e.scale), e.vmax);
}

// stretch_conf's kill test of the block whose first pixel is (i0, j0) of
// pose b: the disparity at the anchor's invz* and one step dv in front of
// it along the exact ray differ by more than 2.8 dv
__device__ __forceinline__ bool killed(const Eye& e, const Params& p, int b,
                                       int i0, int j0, int H, int W) {
  const float* tf = e.tf + 12 * b;
  const float s2x =
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(j0), 0.5f), p.inv_w),
                0.5f);
  const float s2y =
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(i0), 0.5f), p.inv_h),
                0.5f);
  const float den = __fadd_rn(
      __fadd_rn(__fmul_rn(tf[6], s2x), __fmul_rn(tf[7], s2y)), tf[8]);
  const float qx = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(tf[0], s2x), __fmul_rn(tf[1], s2y)),
                tf[2]),
      den);
  const float qy = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(tf[3], s2x), __fmul_rn(tf[4], s2y)),
                tf[5]),
      den);
  const float dsx = __fsub_rn(tf[9], __fmul_rn(tf[11], qx));
  const float dsy = __fsub_rn(tf[10], __fmul_rn(tf[11], qy));
  const float iz = e.invz[(static_cast<long long>(b) * H + i0) * W + j0];
  float d[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float v = k ? __fadd_rn(iz, e.dv) : iz;
    const float x =
        __fadd_rn(__fadd_rn(__fadd_rn(qx, __fmul_rn(v, dsx)), 0.5f), e.dxp);
    const float y =
        __fadd_rn(__fadd_rn(__fadd_rn(qy, __fmul_rn(v, dsy)), 0.5f), e.dyp);
    d[k] = read_disp(e, x, y);
  }
  return fabsf(__fsub_rn(d[0], d[1])) > e.thr;
}

// one eye's view at pixel s = (b, i, j): straight colour and alpha, its hit
struct View {
  float r, g, b, a, hit;
};

__device__ __forceinline__ View view_at(const Eye& e, const Params& p,
                                        long long s, int b, int i, int j) {
  const float4 c = e.rgba[s];
  View o{c.x, c.y, c.z, 0.0f, 0.0f};
  o.a = lif_epilogue::hit_alpha(e.geom, p.taper, p.mask_mode, e.c1[3 * b],
                                e.c1[3 * b + 1], i, j, e.found[s], e.invz[s],
                                c.w, &o.hit);
  return o;
}

__global__ void __launch_bounds__(kThreads) stereo_epilogue_kernel(
    float4* __restrict__ out,  // (B, H, W) the frames
    int H, int W, const __grid_constant__ Params p) {
  __shared__ unsigned char kill[2][kTileH][kTileW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;
  const int b = blockIdx.z;
  const int i = i0 + ty, j = j0 + tx;
  const bool inside = i < H && j < W;
  const long long s = (static_cast<long long>(b) * H + i) * W + j;

  View v[2];
  if (inside) {
    v[0] = view_at(p.eye[0], p, s, b, i, j);
    v[1] = view_at(p.eye[1], p, s, b, i, j);
  }
  // the tile's probes: eye e, block (by, bx) at task e * nb + by * nbx + bx
  const int ds = p.ds;
  const int nbx = kTileW / ds, nb = nbx * (kTileH / ds);
  for (int t = ty * kTileW + tx; t < 2 * nb; t += kThreads) {
    const int e = t / nb, k = t % nb;
    const int pi = (k / nbx) * ds, pj = (k % nbx) * ds;
    if (i0 + pi < H && j0 + pj < W) {
      kill[e][pi][pj] = killed(p.eye[e], p, b, i0 + pi, j0 + pj, H, W);
    }
  }
  __syncthreads();
  if (!inside) return;

  // stretch_conf: 0 where the pixel's block died and the pixel hits
  float conf[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    conf[e] = (kill[e][ty - ty % ds][tx - tx % ds] && v[e].hit > 0.5f)
                  ? 0.0f : 1.0f;
  }
  // occlusion_blend: L from R, then R from the filled L
  const float tenth = static_cast<float>(0.1);
  View& l = v[0];
  View& r = v[1];
  if ((conf[0] == 0.0f && conf[1] == 1.0f) ||
      l.a < __fsub_rn(r.a, tenth)) {
    l = r;
  }
  if ((conf[1] == 0.0f && conf[0] == 1.0f) ||
      r.a < __fsub_rn(l.a, tenth)) {
    r = l;
  }
  const float w = p.w_r[b];
  const float wl = __fsub_rn(1.0f, w);
  float c[3] = {__fadd_rn(__fmul_rn(wl, l.r), __fmul_rn(w, r.r)),
                __fadd_rn(__fmul_rn(wl, l.g), __fmul_rn(w, r.g)),
                __fadd_rn(__fmul_rn(wl, l.b), __fmul_rn(w, r.b))};
  const float la = __fadd_rn(__fmul_rn(wl, l.a), __fmul_rn(w, r.a));

  // composite.over onto the layers in front, premultiplied in the output
  float rgb[3];
  float a;
  if (p.first) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = __fmul_rn(c[ch], la);
    a = la;
  } else {
    const float4 acc = out[s];
    const float m = __fmul_rn(__fsub_rn(1.0f, acc.w), la);
    rgb[0] = __fadd_rn(acc.x, __fmul_rn(m, c[0]));
    rgb[1] = __fadd_rn(acc.y, __fmul_rn(m, c[1]));
    rgb[2] = __fadd_rn(acc.z, __fmul_rn(m, c[2]));
    a = __fadd_rn(la, __fmul_rn(acc.w, __fsub_rn(1.0f, la)));
  }
  if (p.last) {
    float bg[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) bg[ch] = p.bgp ? p.bgp[ch] : p.bg[ch];
    lif_epilogue::finish_rn(rgb, a, bg, p.to_srgb != 0);
  }
  out[s] = make_float4(rgb[0], rgb[1], rgb[2], a);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch, or
// cudaErrorInvalidValue for an empty or ill-shaped call. eyes: on the host,
// the left and right eye-layers' 144-byte records of the wrapper's
// _eye_table, copied into the launch's parameters. w_r: (B,) on the
// device. W is the march's width and the output's (no width pad); ds
// (1, 2 or 4) divides H and W. feather, e0 and e_span are the edge taper's
// numbers (max(feathering, 1e-6), 1 - f, 1 - (1 - f)).
extern "C" int lif_stereo_epilogue(
    const void* eyes, const void* w_r, const void* bg_ptr, void* out, int B,
    int H, int W, int ds, double feather, double e0, double e_span,
    float bg0, float bg1, float bg2, float bg3, int mask_mode, int to_srgb,
    int first, int last, void* stream) {
  if (eyes == nullptr || w_r == nullptr || B < 1 || B > 65535 || H < 1 ||
      W < 1 || (ds != 1 && ds != 2 && ds != 4) || H % ds || W % ds ||
      mask_mode < 0 || mask_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  const Eye* host = static_cast<const Eye*>(eyes);
  p.eye[0] = host[0];
  p.eye[1] = host[1];
  p.w_r = static_cast<const float*>(w_r);
  p.bgp = static_cast<const float*>(bg_ptr);
  p.bg[0] = bg0;
  p.bg[1] = bg1;
  p.bg[2] = bg2;
  p.bg[3] = bg3;
  p.taper.inv_f = 1.0f / static_cast<float>(feather);
  p.taper.e0 = static_cast<float>(e0);
  p.taper.inv_e = 1.0f / static_cast<float>(e_span);
  p.mask_mode = mask_mode;
  p.ds = ds;
  p.inv_w = 1.0f / static_cast<float>(W);
  p.inv_h = 1.0f / static_cast<float>(H);
  p.to_srgb = to_srgb;
  p.first = first;
  p.last = last;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  stereo_epilogue_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(out), H, W, p);
  return static_cast<int>(cudaGetLastError());
}
