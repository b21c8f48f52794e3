"""3x3 projective-transform builders for view synthesis (float32 torch).

The row-major equivalents of the GLSL helpers in the reference renderer
(reference: src/shaders/rayCastMonoLDI.glsl:83-97), as in
lif_tpu.core.transforms. GLSL mat3 constructors are column-major; every
builder here returns the row-major matrix that performs the same
``M @ v`` product.

The matrices are tiny per-call constants: callers build them on the CPU
(exact IEEE float32) and move the results to the render device.
"""

from __future__ import annotations

import torch

__all__ = [
    "FLIP_Z",
    "inv3",
    "mat_from_focal",
    "mat_from_roll",
    "mat_from_skew",
    "mat_from_slant",
    "mm",
    "shader_rotation",
]

# Z-axis flip: converts between -Z-forward (scene convention, as in THREE)
# and +Z-forward (shader convention). reference: rayCastMonoLDI.glsl:97
FLIP_Z = torch.diag(torch.tensor([1.0, 1.0, -1.0], dtype=torch.float32))


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 matmul in float32."""
    return torch.matmul(a, b)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def mat_from_slant(sl_x, sl_y) -> torch.Tensor:
    """Rotation from tangent-space slant. reference: rayCastMonoLDI.glsl:63-71.

    GLSL columns (invsqx,0,slx*invsq), (0,invsqy,sly*invsq),
    (-slx*invsqx,-sly*invsqy,invsq) transposed to row-major.
    """
    sl_x, sl_y = _f32(sl_x), _f32(sl_y)
    invsqx = 1.0 / torch.sqrt(1.0 + sl_x * sl_x)
    invsqy = 1.0 / torch.sqrt(1.0 + sl_y * sl_y)
    invsq = 1.0 / torch.sqrt(1.0 + sl_x * sl_x + sl_y * sl_y)
    zero = torch.zeros_like(sl_x)
    return torch.stack(
        [
            torch.stack([invsqx, zero, -sl_x * invsqx], dim=-1),
            torch.stack([zero, invsqy, -sl_y * invsqy], dim=-1),
            torch.stack([sl_x * invsq, sl_y * invsq, invsq], dim=-1),
        ],
        dim=-2,
    )


def mat_from_roll(roll_degrees) -> torch.Tensor:
    """Roll about +Z, angle in degrees. reference: rayCastMonoLDI.glsl:73-81.

    Uses the shader's truncated PI constant (3.141593), as the reference
    does, in float32.
    """
    th = _f32(roll_degrees)
    rad = th * _f32(3.141593) / 180.0
    c, s = torch.cos(rad), torch.sin(rad)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zero], dim=-1),
            torch.stack([s, c, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def mat_from_skew(sk_x, sk_y) -> torch.Tensor:
    """Frustum-skew shear from tangent angles. reference: rayCastMonoLDI.glsl:83-88.

    Row-major: [[1,0,-skx],[0,1,-sky],[0,0,1]].
    """
    sk_x, sk_y = _f32(sk_x), _f32(sk_y)
    zero = torch.zeros_like(sk_x)
    one = torch.ones_like(sk_x)
    return torch.stack(
        [
            torch.stack([one, zero, -sk_x], dim=-1),
            torch.stack([zero, one, -sk_y], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def mat_from_focal(f_x, f_y) -> torch.Tensor:
    """Focal scaling, f expressed as a fraction of the image dimension.
    reference: rayCastMonoLDI.glsl:90-95."""
    f_x, f_y = _f32(f_x), _f32(f_y)
    zero = torch.zeros_like(f_x)
    one = torch.ones_like(f_x)
    return torch.stack(
        [
            torch.stack([f_x, zero, zero], dim=-1),
            torch.stack([zero, f_y, zero], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse via the adjugate (the GLSL ES fallback,
    reference: rayCastMonoLDI.glsl:119-129)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack(
        [
            torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def shader_rotation(rotation) -> torch.Tensor:
    """Convert a camera-local rotation matrix (scene convention, -Z forward)
    into the shader's +Z-forward frame: ``flipZ @ R.T @ flipZ``.
    reference: rayCastMonoLDI.glsl:316, 332."""
    rt = _f32(rotation).transpose(-1, -2)
    flip = FLIP_Z.to(rt.device)
    return mm(mm(flip, rt), flip)
