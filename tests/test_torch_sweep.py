"""The soft, differentiable plane sweep (lif_tpu_torch.ops.sweep) against
lif_tpu (CPU): the forward and its gradients.

The same seeded projector and poses go through lif_tpu.ops.sweep.render_sweep
(JAX on the CPU) and lif_tpu_torch.ops.sweep.render_sweep (plain torch on
CPU tensors). Gates: the forward max abs < 1e-5; the gradients of a mean
squared error with respect to disp, c1 and rot1 against jax.grad, max abs
under 1e-4 of the largest gradient. The poses are generic (off the texel
lattice): where a pose reads the source exactly at texel centres (no y
and z offset, identity rotation), a bilinear read's derivative along that
axis is one-sided, and the two packages' float rounding picks different
sides in a few rows (tests/test_torch_train.py measures what that does to
a fit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.core.pose import relative_view_pose
from lif_tpu.ops import sweep as jsweep
from lif_tpu_torch.ops import sweep as tsweep

from .scenes import smooth_noise
from .test_rotated_march import _rotx, _roty

torch.set_num_threads(1)


def _projector(rng, h=24, w=32, ldi=False):
    kw = {}
    if ldi:
        kw = dict(
            mask=(smooth_noise(rng, h, w, octaves=2) > 0.3).astype(np.float32),
            extra_layers=[dict(
                rgb=rng.random((h + 4, w + 8, 3)).astype(np.float32),
                disp=smooth_noise(rng, h + 4, w + 8).astype(np.float32),
                focal_px=0.7 * w, invz_min=0.6, invz_max=0.1)],
        )
    return lif_tpu.projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        smooth_noise(rng, h, w).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
        skew=(0.01, -0.02) if ldi else (0.0, 0.0), **kw,
    )


def _poses(p, b=3):
    """Generic relative poses (B, 3) and (B, 3, 3), float32."""
    rel = [relative_view_pose(
        np.asarray(p.position, np.float64), np.asarray(p.rotation, np.float64),
        np.array([0.04 * i - 0.03, 0.013 + 0.01 * i, 0.02 * i - 0.011]),
        _rotx(1.5 * i - 1.1) @ _roty(2.0 - i))
        for i in range(b)]
    return (np.stack([r[0] for r in rel]).astype(np.float32),
            np.stack([r[1] for r in rel]).astype(np.float32))


def _args(p, w, h, f2=None, skew2=(0.0, 0.0)):
    """render_sweep's projector arguments and the camera's f2/skew2, as
    host numpy (lif_tpu's layout)."""
    return dict(
        rgb=np.asarray(p.rgb), mask=np.asarray(p.mask),
        layer_res=np.asarray(p.layer_res), invz_min=np.asarray(p.invz_min),
        invz_max=np.asarray(p.invz_max), focal=np.asarray(p.focal),
        skew=np.asarray(p.skew), f2=np.float32(0.78 * w if f2 is None else f2),
        skew2=np.asarray(skew2, np.float32),
    )


def _jax_render(a, disp, c1, rot1, w, h, n, **kw):
    return jsweep.render_sweep(
        jnp.asarray(a["rgb"]), disp, jnp.asarray(a["mask"]),
        jnp.asarray(a["layer_res"]), jnp.asarray(a["invz_min"]),
        jnp.asarray(a["invz_max"]), jnp.asarray(a["focal"]),
        jnp.asarray(a["skew"]), c1, rot1, jnp.float32(a["f2"]),
        jnp.asarray(a["skew2"]), jnp.asarray([0.1, 0.2, 0.3, 0.5], jnp.float32),
        out_w=w, out_h=h, num_layers=n, num_planes=12, **kw)


def _torch_render(a, disp, c1, rot1, w, h, n, **kw):
    return tsweep.render_sweep(
        torch.tensor(a["rgb"]), disp, torch.tensor(a["mask"]), a["layer_res"],
        a["invz_min"], a["invz_max"], a["focal"], a["skew"], c1, rot1,
        a["f2"], a["skew2"], np.float32([0.1, 0.2, 0.3, 0.5]), out_w=w,
        out_h=h, num_layers=n, num_planes=12, **kw)


@pytest.mark.parametrize("case", ["single", "ldi", "zoom_srgb", "unbatched"])
def test_render_sweep_forward_matches_lif_tpu(rng, case):
    """The forward on a batch of generic poses: one layer; a masked,
    skewed 2-layer LDI with an outpainted back layer of another focal; a
    zoomed, skewed camera with the sRGB output; a single unbatched pose."""
    ldi = case == "ldi"
    p = _projector(rng, ldi=ldi)
    h, w = 24, 32
    a = _args(p, w, h, f2=0.9 * w if case == "zoom_srgb" else None,
              skew2=(0.02, 0.01) if case == "zoom_srgb" else (0.0, 0.0))
    c1, rot1 = _poses(p)
    if case == "unbatched":
        c1, rot1 = c1[1], rot1[1]
    n = 2 if ldi else 1
    kw = dict(to_srgb=case == "zoom_srgb")
    want = np.asarray(_jax_render(a, jnp.asarray(p.disp), jnp.asarray(c1),
                                  jnp.asarray(rot1), w, h, n, **kw))
    got = _torch_render(a, torch.tensor(np.asarray(p.disp)),
                        torch.tensor(c1), torch.tensor(rot1), w, h, n, **kw)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5
    assert want[..., 3].mean() > 0.5


def test_render_sweep_tile_matches_lif_tpu(rng):
    """The tile arguments: the (8, 12) tile at row 10, column 16 of the
    24x32 framebuffer equals lif_tpu's tile and the full render's crop."""
    p = _projector(rng)
    a = _args(p, 32, 24)
    c1, rot1 = _poses(p)
    tile = dict(full_w=32, full_h=24, row_start=10, col_start=16)
    want = np.asarray(_jax_render(a, jnp.asarray(p.disp), jnp.asarray(c1),
                                  jnp.asarray(rot1), 12, 8, 1, **tile))
    got = _torch_render(a, torch.tensor(np.asarray(p.disp)),
                        torch.tensor(c1), torch.tensor(rot1), 12, 8, 1, **tile)
    full = _torch_render(a, torch.tensor(np.asarray(p.disp)),
                         torch.tensor(c1), torch.tensor(rot1), 32, 24, 1)
    assert np.abs(got.numpy() - want).max() < 1e-5
    assert np.abs(got.numpy() - full[:, 10:18, 16:28].numpy()).max() < 1e-5


@pytest.mark.parametrize("ldi", [False, True])
def test_render_sweep_gradients_match_jax_grad(rng, ldi):
    """Gradients of the mean squared error against a seeded target with
    respect to disp (through the bilinear reads' texels), c1 and rot1
    (through the sample positions and the 3x3 transforms), against
    jax.grad of the same loss: max abs under 1e-4 of each gradient's
    largest entry, and the same sign wherever an entry exceeds 1e-3 of
    it."""
    p = _projector(rng, ldi=ldi)
    h, w = 24, 32
    n = 2 if ldi else 1
    a = _args(p, w, h)
    c1, rot1 = _poses(p)
    target = rng.random((3, h, w, 3)).astype(np.float32)

    def jloss(disp, c, r):
        img = _jax_render(a, disp, c, r, w, h, n, to_srgb=False)
        return jnp.mean((img[..., :3] - target) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(p.disp), jnp.asarray(c1), jnp.asarray(rot1))
    leaves = [torch.tensor(np.asarray(x), requires_grad=True)
              for x in (p.disp, c1, rot1)]
    img = _torch_render(a, *leaves, w, h, n, to_srgb=False)
    torch.mean((img[..., :3] - torch.tensor(target)) ** 2).backward()
    for name, g, leaf in zip(("disp", "c1", "rot1"), want, leaves):
        g = np.asarray(g)
        got = leaf.grad.numpy()
        scale = np.abs(g).max()
        assert scale > 0, name
        assert np.abs(got - g).max() < 1e-4 * scale, name
        big = np.abs(g) > 1e-3 * scale
        assert (np.sign(got[big]) == np.sign(g[big])).all(), name
