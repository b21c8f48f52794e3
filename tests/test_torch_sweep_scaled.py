"""Parity of the port's scaled march modules with lif_tpu (CPU).

The same numpy inputs go through lif_tpu (JAX on the CPU: its XLA twin
render_scaled_xla, and the Pallas kernel in interpret mode) and through
lif_tpu_torch (the plain twin on CPU tensors). Host planning is float64
numpy and must be EQUAL, including which batches raise ValueError: it
decides routing. The march is held to the repo's kernel-vs-twin bounds
(tests/test_sweep_scaled.py:167, :187-188): color max abs < 1e-4, depth
max abs < 1e-4 with `found` equal — except that XLA contracts
multiply-adds into FMAs on the CPU and the port does not, so an isolated
grazing crossing can flip; such flips are counted and must stay under
0.1% of pixels (the bound of tests/test_torch_sweep_target.py). The CUDA
kernel runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.ops import sweep_scaled as jss
from lif_tpu_torch.ops import sweep_scaled as tss

from .test_sweep_march import _psnr, _scene

torch.set_num_threads(1)

IZMIN, IZMAX = 2.0, 0.1

# tests/test_sweep_scaled.py:32-40
_FAMILIES = {
    "lateral": ([0.05, 0.0, 0.0], 1.0),
    "dolly": ([0.03, 0.0, 0.04], 1.0),
    "diagonal": ([0.04, 0.02, 0.0], 1.0),
    "general": ([0.02, 0.01, 0.03], 1.0),
    "zoom": ([0.03, 0.0, 0.0], 1.08),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plan_args(w, h, c1s, fr, ow=None, oh=None):
    c1s = np.asarray(c1s, np.float64).reshape(-1, 3)
    return (w, h, ow or w, oh or h, 0.78 * (ow or w), fr,
            float(np.abs(c1s[:, 0]).max()), float(np.abs(c1s[:, 1]).max()),
            float(min(c1s[:, 2].min(), 0.0)), float(max(c1s[:, 2].max(), 0.0)),
            IZMIN, IZMAX)


def _setup(rng, family, h=96, w=128, step_px=0.75, lo=0.0, hi=1.0):
    c1, fr = _FAMILIES[family]
    rgb, disp, mask = _scene(rng, h=h, w=w)
    disp = (lo + (hi - lo) * disp).astype(np.float32)
    args = _plan_args(w, h, [c1], fr)
    grid, k = jss.parallax_step_grid(0.78 * w, c1, fr, w, h, IZMIN, IZMAX,
                                     step_px=step_px)
    return (rgb, disp, mask, 0.78 * w, fr, c1, jss.scaled_plan(*args),
            tss.scaled_plan(*args), grid, k)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
@pytest.mark.parametrize("dims", [(128, 96, 128, 96), (512, 480, 128, 96),
                                  (136, 100, 120, 96)])
def test_planning_equal(family, dims):
    """scaled_plan, parallax_step_grid and parallax_step_grids_batch:
    equal outputs (also for an outpainted source and a width that only
    8-px bands divide)."""
    w, h, ow, oh = dims
    c1, fr = _FAMILIES[family]
    c1s = [c1, [-0.5 * c1[0], 0.7 * c1[1], -c1[2]]]
    args = _plan_args(w, h, c1s, fr, ow, oh)
    for dxu, dyu in ((0.0, 0.0), (3.5, -1.25)):
        pa = jss.scaled_plan(*args, dx_user=dxu, dy_user=dyu)
        pb = tss.scaled_plan(*args, dx_user=dxu, dy_user=dyu)
        assert tuple(pa) == tuple(pb)
    f1 = 0.78 * ow
    for step_px, num_planes in ((1.0, None), (0.75, None), (1.0, 96)):
        ga, ka = jss.parallax_step_grid(f1, c1, fr, ow, oh, IZMIN, IZMAX,
                                        step_px=step_px, num_planes=num_planes)
        gb, kb = tss.parallax_step_grid(f1, c1, fr, ow, oh, IZMIN, IZMAX,
                                        step_px=step_px, num_planes=num_planes)
        assert ka == kb and np.array_equal(ga, gb)
        ga, ka = jss.parallax_step_grids_batch(
            f1, c1s, fr, ow, oh, IZMIN, IZMAX, step_px=step_px,
            num_planes=num_planes)
        gb, kb = tss.parallax_step_grids_batch(
            f1, c1s, fr, ow, oh, IZMIN, IZMAX, step_px=step_px,
            num_planes=num_planes)
        assert ka == kb and np.array_equal(ga, gb)


@pytest.mark.parametrize("case", ["scale_spread", "y_budget", "odd_width"])
def test_plan_rejections_equal(case):
    """The batches lif_tpu's planner rejects raise the same ValueError in
    the port (the renderer routes them to the sweep)."""
    args = {
        "scale_spread": _plan_args(128, 96, [[0.0, 0.0, 0.0]], 2.0),
        "y_budget": _plan_args(128, 96, [[0.0, 2.0, 0.0]], 1.0),
        "odd_width": _plan_args(127, 96, [[0.03, 0.0, 0.0]], 1.0),
    }[case]
    with pytest.raises(ValueError) as ja:
        jss.scaled_plan(*args)
    with pytest.raises(ValueError) as tb:
        tss.scaled_plan(*args)
    assert str(ja.value) == str(tb.value)


def _depth_bounds(f_j, v_j, f_t, v_t):
    """found flips < 0.1% (FMA contraction, see the module docstring);
    depth max abs < 1e-4 where found agrees."""
    f_j, f_t = np.asarray(f_j), np.asarray(f_t)
    assert (f_j != f_t).mean() < 1e-3
    err = np.abs(np.asarray(v_j) - np.asarray(v_t)) * (f_j == f_t)
    assert err.max() < 1e-4
    assert f_t.mean() > 0.5


def _color_bounds(ref, got):
    """color max abs < 1e-4 outside flipped crossings (< 0.1% of pixels)."""
    err = np.abs(np.asarray(ref) - np.asarray(got)).max(-1)
    assert (err >= 1e-4).mean() < 1e-3
    assert _psnr(np.asarray(got), np.asarray(ref)) >= 60.0


@pytest.mark.parametrize("family", sorted(_FAMILIES))
@pytest.mark.parametrize("refine", [0, 2])
def test_plain_twin_matches_xla_twin(rng, family, refine):
    """render_scaled_plain against render_scaled_xla, depth only and full
    color, at refine 0 and 2."""
    rgb, disp, mask, f1, fr, c1, pa, pb, grid, k = _setup(rng, family)
    tex = _t(rgb, disp, mask)
    kw = dict(mask_mode="none", refine=refine)
    f_j, v_j = jss.render_scaled_xla(
        rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(c1, jnp.float32), f1, fr,
        grid, jnp.zeros(4), pa, k, depth_only=True, **kw)
    f_t, v_t = tss.render_scaled_plain(
        *tex, IZMIN, IZMAX, c1, f1, fr, grid, None, pb, k, depth_only=True,
        **kw)
    _depth_bounds(f_j, v_j, f_t.numpy(), v_t.numpy())
    bg = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    ref = jss.render_scaled_xla(
        rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(c1, jnp.float32), f1, fr,
        grid, jnp.asarray(bg), pa, k, **kw)
    got = tss.render_scaled_plain(*tex, IZMIN, IZMAX, c1, f1, fr, grid, bg,
                                  pb, k, **kw)
    _color_bounds(ref, got.numpy())


def test_raw_and_mask_modes_match(rng):
    """The raw (rgba*, alpha, hit, invz*) tuple and mask_mode multiply /
    hard with a dx/dy shift, against lif_tpu."""
    rgb, disp, mask, f1, fr, c1, pa, pb, grid, k = _setup(rng, "general")
    mask = (rng.random(mask.shape) > 0.15).astype(np.float32)
    tex = _t(rgb, disp, mask)
    for mode, raw in (("multiply", True), ("hard", False)):
        kw = dict(mask_mode=mode, raw=raw, refine=1, dx_user=1.5,
                  dy_user=-0.5, to_srgb=False)
        ref = jss.render_scaled_xla(
            rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(c1, jnp.float32), f1,
            fr, grid, jnp.zeros(4), pa, k, **kw)
        got = tss.render_scaled_plain(*tex, IZMIN, IZMAX, c1, f1, fr, grid,
                                      np.zeros(4, np.float32), pb, k, **kw)
        for a, b in zip(ref if raw else [ref], got if raw else [got]):
            err = np.abs(np.asarray(a) - b.numpy())
            assert (err >= 1e-4).mean() < 1e-3


@pytest.mark.parametrize("refine", [0, 2])
def test_start_skip_scene_matches(rng, refine):
    """Disparity in [0.05, 0.35]: no texel reaches the first ~60% of the
    ladder (the planes the CUDA kernel skips); the twin still matches."""
    rgb, disp, mask, f1, fr, c1, pa, pb, grid, k = _setup(
        rng, "dolly", lo=0.05, hi=0.35)
    assert (grid > IZMAX + 0.35 * (IZMIN - IZMAX)).mean() > 0.5
    f_j, v_j = jss.render_scaled_xla(
        rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(c1, jnp.float32), f1, fr,
        grid, jnp.zeros(4), pa, k, refine=refine, depth_only=True)
    f_t, v_t = tss.render_scaled_plain(
        *_t(rgb, disp, mask), IZMIN, IZMAX, c1, f1, fr, grid, None, pb, k,
        refine=refine, depth_only=True)
    _depth_bounds(f_j, v_j, f_t.numpy(), v_t.numpy())


def test_depth_only_matches_pallas_interpret(rng):
    """The TPU kernel itself (interpret mode, 128x64 as
    tests/test_sweep_scaled.py:170-188) against the port's depth-only
    march: texel-space thresholds there, inverse-depth diffs here, so
    grazing crossings may flip within the bound."""
    from lif_tpu.ops.pallas.sweep_scaled import render_scaled_batch_pallas

    c1s = np.array([[0.04, 0.01, 0.03], [0.05, 0.0, 0.0]], np.float32)
    rgb, disp, mask = _scene(rng, h=128, w=64)
    f1 = 0.78 * 64
    args = _plan_args(64, 128, c1s, 1.0)
    grids, k = jss.parallax_step_grids_batch(f1, c1s, 1.0, 64, 128, IZMIN,
                                             IZMAX)
    f_k, v_k = render_scaled_batch_pallas(
        rgb, disp, mask, IZMIN, IZMAX, c1s, f1, 1.0, grids, jnp.zeros(4),
        jss.scaled_plan(*args), k, mask_mode="none", refine=2,
        depth_only=True, interpret=True)
    f_t, v_t = tss.render_scaled_batch(
        *_t(rgb, disp, mask), IZMIN, IZMAX, c1s, f1, 1.0, grids, None,
        tss.scaled_plan(*args), k, refine=2, depth_only=True)
    _depth_bounds(f_k, v_k, f_t.numpy(), v_t.numpy())


def test_batch_equals_per_pose(rng):
    """The batched dispatch equals per-pose renders exactly (shared and
    per-pose ladders)."""
    c1s = np.array([[0.03, 0.0, 0.02], [0.05, 0.01, 0.0], [0.0, 0.02, 0.03]],
                   np.float32)
    rgb, disp, mask = _scene(rng, h=96, w=128)
    tex = _t(rgb, disp, mask)
    f1 = 0.78 * 128
    plan = tss.scaled_plan(*_plan_args(128, 96, c1s, 1.0))
    grids, k = tss.parallax_step_grids_batch(f1, c1s, 1.0, 128, 96, IZMIN,
                                             IZMAX)
    for planes in (grids, grids[0]):
        batch = tss.render_scaled_batch(*tex, IZMIN, IZMAX, c1s, f1, 1.0,
                                        planes, np.zeros(4), plan, k)
        for i, c1 in enumerate(c1s):
            one = tss.render_scaled_plain(
                *tex, IZMIN, IZMAX, c1, f1, 1.0,
                planes[i] if planes.ndim == 2 else planes, np.zeros(4), plan,
                k)
            assert torch.equal(batch[i], one)


@pytest.mark.parametrize("mask_mode,to_srgb", [("none", True),
                                               ("multiply", False)])
def test_fetch_batch_matches_lif_tpu(rng, mask_mode, to_srgb):
    """The production tier (depth-only march + packed color fetch +
    epilogue) against lif_tpu's render_scaled_fetch_batch, with a
    width-pad style dx shift."""
    c1s = np.array([[0.03, 0.01, 0.04], [-0.02, 0.0, -0.03]], np.float32)
    rgb, disp, mask = _scene(rng, h=96, w=128)
    mask = (rng.random(mask.shape) > 0.15).astype(np.float32)
    f1 = 0.78 * 128
    args = _plan_args(128, 96, c1s, 1.08)
    grids, k = jss.parallax_step_grids_batch(f1, c1s, 1.08, 128, 96, IZMIN,
                                             IZMAX)
    bg = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    kw = dict(feathering=0.1, mask_mode=mask_mode, to_srgb=to_srgb,
              refine=2, dx_user=0.5)
    ref = jss.render_scaled_fetch_batch(
        rgb, disp, mask, IZMIN, IZMAX, c1s, f1, 1.08, jnp.asarray(grids),
        jnp.asarray(bg), jss.scaled_plan(*args, dx_user=0.5), k, **kw)
    got = tss.render_scaled_fetch_batch(
        *_t(rgb, disp, mask), IZMIN, IZMAX, c1s, f1, 1.08, grids, bg,
        tss.scaled_plan(*args, dx_user=0.5), k, **kw)
    assert got.shape == (2, 96, 128, 4)
    _color_bounds(ref, got.numpy())


def test_heavily_outpainted_source(rng):
    """A source much taller and wider than the output (480x512 for
    128x96: lif_tpu's padded_h fix, tests/test_sweep_scaled.py:109-138)
    plans and renders through render_fast_batch's scaled tier like
    lif_tpu's, and >= 40 dB against the exact march."""
    oh, ow = 96, 128
    sh, sw = oh + 2 * 192, ow + 2 * 192
    rgb, disp, _ = _scene(rng, h=sh, w=sw)
    jp = lif_tpu.projector_from_arrays(
        rgb, disp, focal_px=0.78 * ow, invz_min=2.0, invz_max=0.1,
        baseline=1.0)
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    ref, jt = lif_tpu.render_fast_batch(jp, [lif_tpu.Camera.create(
        ow, oh, focal_px=0.78 * ow, position=[0.02, 0.01, 0.0])],
        mask_mode="none", return_tiers=True)
    cam = lif_tpu_torch.Camera.create(ow, oh, focal_px=0.78 * ow,
                                      position=[0.02, 0.01, 0.0])
    got, tt = lif_tpu_torch.render_fast_batch(tp, [cam], mask_mode="none",
                                              return_tiers=True)
    assert tuple(jt) == tt == ("scaled",)
    _color_bounds(ref, got.numpy())
    exact = lif_tpu_torch.render_mono_view(tp, cam, mask_mode="none",
                                           num_steps=320)
    sl = np.s_[10:-10, 10:-10]
    assert _psnr(got[0].numpy()[sl], exact.numpy()[sl]) > 40.0


def test_plain_march_rejects_other_devices(rng):
    """The dispatch takes CUDA (the kernel) or CPU (the plain twin)
    tensors; any other device raises."""
    rgb, disp, mask, f1, fr, c1, pa, pb, grid, k = _setup(rng, "dolly")
    tex = [t.to("meta") for t in _t(rgb, disp, mask)]
    with pytest.raises(NotImplementedError, match="CUDA or CPU"):
        tss.render_scaled_batch(*tex, IZMIN, IZMAX, [c1], f1, fr, grid,
                                None, pb, k, depth_only=True)
