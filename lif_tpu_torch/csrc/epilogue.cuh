// Device code shared by the epilogue kernels (csrc/sweep_march.cu's
// lif_lateral_epilogue and csrc/stereo_epilogue.cu): the float32
// operators of the lateral tier's hit test (ops/sweep_march.py::
// hit_and_alpha, composite.edge_alpha), of composite.
// finish_over_background and of core/color.py::linear_to_srgb.
//
// Arithmetic: each operator an explicitly rounded intrinsic in PyTorch's
// order (the libraries are built with --fmad=false), with PyTorch's CUDA
// semantics: a division by a Python number is the product with the
// number's float32 reciprocal, taken on the host; each Python constant is
// a double rounded to float; clamps pass NaN through. The build hashes
// this header with every source (ops/cuda/build.py).

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace lif_epilogue {

// clamp(x, lo, hi) as PyTorch's CUDA clamp: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
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

// One march layer's hit-test numbers, rounded to float32 as the PyTorch
// chain takes them (32 bytes: the wrappers' records hold it as 8 floats).
struct HitGeom {
  float f1, bx, by, off_x, off_y, crop_y;
  float inv_src_w, inv_src_h;  // 1 / src_w, 1 / (src_h + 2 crop_y)
};
static_assert(sizeof(HitGeom) == 32, "the wrappers' 8 floats");

// composite.edge_alpha's taper: smoothstep(0, f) and smoothstep(1 - f, 1)
struct Taper {
  float inv_f;      // 1 / f, f = max(feathering, 1e-6)
  float e0, inv_e;  // 1 - f, 1 / (1 - (1 - f))
};

// hit_and_alpha at output pixel (i, j) of a pose at (cx, cy): the hit test
// at the true source position and edge_alpha in mask_mode (0 none, 1
// multiply, 2 hard). Returns the alpha, and the hit in *hit.
__device__ __forceinline__ float hit_alpha(const HitGeom& g, const Taper& t,
                                           int mask_mode, float cx, float cy,
                                           int i, int j, float found,
                                           float iz, float mask, float* hit) {
  const float sx = __fmul_rn(cx, g.f1);
  const float sy = __fmul_rn(cy, g.f1);
  const float gx = __fadd_rn(
      __fsub_rn(__fadd_rn(static_cast<float>(j), g.bx), __fmul_rn(sx, iz)),
      g.off_x);
  const float gy = __fadd_rn(
      __fsub_rn(__fadd_rn(static_cast<float>(i), g.by), __fmul_rn(sy, iz)),
      g.off_y);
  const float u = __fmul_rn(__fadd_rn(gx, 0.5f), g.inv_src_w);
  const float v = __fmul_rn(__fadd_rn(__fadd_rn(gy, g.crop_y), 0.5f),
                            g.inv_src_h);
  const float inside =
      (u > 0.0f && u < 1.0f && v > 0.0f && v < 1.0f) ? 1.0f : 0.0f;
  const float tap = __fmul_rn(
      __fmul_rn(__fmul_rn(smoothstep_rn(u, 0.0f, t.inv_f),
                          __fsub_rn(1.0f, smoothstep_rn(u, t.e0, t.inv_e))),
                smoothstep_rn(v, 0.0f, t.inv_f)),
      __fsub_rn(1.0f, smoothstep_rn(v, t.e0, t.inv_e)));
  float h = __fmul_rn(found, inside);
  float alpha = __fmul_rn(h, tap);
  if (mask_mode == 1) {
    alpha = __fmul_rn(alpha, clamp_nan(mask, 0.0f, 1.0f));
  } else if (mask_mode == 2) {
    const float keep = mask >= 0.5f ? 1.0f : 0.0f;
    alpha = __fmul_rn(alpha, keep);
    h = __fmul_rn(h, keep);
  }
  *hit = h;
  return alpha;
}

// finish_over_background: premultiplied rgb and alpha over the (4,)
// background bg, then sRGB if to_srgb
__device__ __forceinline__ void finish_rn(float (&rgb)[3], float& a,
                                          const float (&bg)[4],
                                          bool to_srgb) {
  const float t = __fsub_rn(1.0f, a);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    rgb[ch] = __fadd_rn(__fmul_rn(__fmul_rn(bg[ch], bg[3]), t), rgb[ch]);
    if (to_srgb) rgb[ch] = srgb_rn(rgb[ch]);
  }
  a = __fadd_rn(bg[3], __fmul_rn(a, __fsub_rn(1.0f, bg[3])));
}

}  // namespace lif_epilogue
