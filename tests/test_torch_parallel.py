"""The port's multi-rank layer (torch.distributed, gloo on the CPU) against
lif_tpu's shard_map on the conftest's virtual CPU mesh.

Each world size (1, 2, 4 and 8 ranks) is ONE launch of
parallel.launch.run_ranks that runs every rank body of
tests/torch_rank_bodies.py (torch only: a spawned rank must not import
jax) on seeded inputs made here; every rank returns its whole result and
all ranks must agree. Each function of parallel.sharding is one
parametrised test over the world sizes, held to lif_tpu's same function
on jax.devices()[:n] at lif_tpu's own tolerances
(tests/test_parallel.py: 1e-5 tiled, 2e-4 fast; the exact trajectory
3e-5, the packages' rounding of the march's multiply-adds) and
to the port's unsharded render at 1e-6 (the fused view x tile render to
the port's one-process fusion). The sharded fit runs at (data, tile) =
(4, 2) on poses 1 mm off the texel lattice: its losses within rtol 2e-4
of lif_tpu's meshed fit (tests/test_train.py) and the first three within
1e-5 of the port's one-process fit, its parameters equal on every rank.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.core.pose import orbit_pose
from lif_tpu.parallel import sharding as jsharding
from lif_tpu.train import fit as jfit
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import raycast as traycast
from lif_tpu_torch.parallel import sharding as tsharding
from lif_tpu_torch.parallel.launch import run_ranks
from lif_tpu_torch.train import fit as tfit

from . import torch_rank_bodies as bodies
from .scenes import smooth_noise
from .test_torch_train import _problem

torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 4, 8)
FAMILIES = ("lateral", "orbit", "ldi", "skewed")
H, W = 32, 48
FIT_SHAPE, FIT_STEPS = (4, 2), 5
LAUNCH_TIMEOUT_S = 300.0


def _pair(rgb, disp, **kw):
    """A lif_tpu projector and the port's copy on CPU tensors."""
    jp = lif_tpu.projector_from_arrays(rgb, disp, **kw)
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _cams(w, h, positions, rotations=None, **kw):
    """lif_tpu's and the port's cameras at the same poses."""
    rotations = [None] * len(positions) if rotations is None else rotations
    return tuple(
        [pkg.Camera.create(w, h, focal_px=0.78 * w, position=p, rotation=r,
                           **kw) for p, r in zip(positions, rotations)]
        for pkg in (lif_tpu, lif_tpu_torch))


@functools.lru_cache(maxsize=None)
def _inputs():
    """The seeded inputs of every case, in both packages."""
    rng = np.random.default_rng(0)
    kw = dict(focal_px=0.78 * W, invz_min=2.0, invz_max=0.2, baseline=1.0)
    inp = {}
    inp["proj"] = _pair(rng.random((H, W, 3)).astype(np.float32),
                        smooth_noise(rng, H, W).astype(np.float32),
                        position=(0.05, 0.02, 0.0), **kw)
    inp["tiled_cam"] = _cams(W, H, [(0.1, 0.0, 0.05)])
    inp["traj"] = np.stack([[0.02 * i, 0.0, 0.01 * i] for i in range(8)])
    inp["template"] = _cams(W, H, [(0.0, 0.0, 0.0)])

    fast = {}
    plain = _pair(rng.random((H, W, 3)).astype(np.float32),
                  smooth_noise(rng, H, W).astype(np.float32), **kw)
    lateral = np.stack([[0.005 * (i + 1), 0.0, 0.0] for i in range(8)])
    fast["lateral"] = (plain, lateral, None, {})
    extra = [dict(rgb=rng.random((H, W, 3)).astype(np.float32),
                  disp=smooth_noise(rng, H, W).astype(np.float32),
                  mask=(smooth_noise(rng, H, W) > 0.4).astype(np.float32),
                  focal_px=0.78 * W, invz_min=1.0, invz_max=0.1)]
    ldi = _pair(rng.random((H, W, 3)).astype(np.float32),
                smooth_noise(rng, H, W).astype(np.float32),
                extra_layers=extra, **kw)
    fast["ldi"] = (ldi, lateral * 1.2, None, {})
    fast["skewed"] = (plain, lateral * 0.8, None, {"skew": (0.02, -0.01)})
    ho, wo = 64, 128  # the target tier needs a 128-divisible width
    orbit = _pair(rng.random((ho + 16, wo, 3)).astype(np.float32),
                  smooth_noise(rng, ho + 16, wo).astype(np.float32),
                  **dict(kw, focal_px=0.78 * wo))
    poses = [orbit_pose(np.array([0.0, 0.0, -1.5]), 1.5,
                        theta=np.deg2rad(t)) for t in np.linspace(-6, 6, 8)]
    fast["orbit"] = (orbit, np.stack([p for p, _ in poses]),
                     np.stack([r for _, r in poses]), {"size": (wo, ho)})
    inp["fast"] = fast

    inp["fused"] = [
        _pair(rng.random((H, W, 3)).astype(np.float32),
              smooth_noise(rng, H, W).astype(np.float32),
              position=(0.03 * i - 0.1, 0.0, 0.0), **kw)
        for i in range(8)
    ]
    inp["fused_cam"] = _cams(W, H, [(0.02, 0.0, 0.0)])
    inp["fit"] = _problem(np.random.default_rng(0), off_lattice=True, b=8)
    return inp


def _fast_case(family):
    """(lif_tpu projector, port projector, positions, rotations, lif_tpu
    template, port template) of one pose family."""
    (jp, tp), positions, rotations, kw = _inputs()["fast"][family]
    w, h = kw.get("size", (W, H))
    (jcam,), (tcam,) = _cams(w, h, [(0.0, 0.0, 0.0)],
                             skew=kw.get("skew", (0.0, 0.0)))
    return jp, tp, positions, rotations, jcam, tcam


def _rank_cases(n):
    """The cases of the n-rank launch (see tests/torch_rank_bodies.py)."""
    inp = _inputs()
    host = bodies.to_host
    tp = host(inp["proj"][1])
    cases = {
        "tiled": ("tiled", dict(proj=tp, cam=inp["tiled_cam"][1][0])),
        "trajectory": ("trajectory", dict(
            proj=tp, positions=inp["traj"],
            rotations=np.stack([np.eye(3)] * len(inp["traj"])),
            cam=inp["template"][1][0])),
        "fused": ("fused", dict(projs=[host(t) for _, t in inp["fused"]],
                                cam=inp["fused_cam"][1][0])),
    }
    for family in FAMILIES:
        _, fp, positions, rotations, _, tcam = _fast_case(family)
        cases[f"fast_{family}"] = ("fast", dict(
            proj=host(fp), positions=positions, cam=tcam,
            rotations=rotations))
    if n > 1:
        cases["errors"] = ("errors", dict(
            proj=tp, cam=inp["template"][1][0],
            cam_odd_h=lif_tpu_torch.Camera.create(
                W, n * 4 + 1, focal_px=0.78 * W)))
    if n == FIT_SHAPE[0] * FIT_SHAPE[1]:
        _, ftp, positions, rotations, _, tcam, targets, _ = inp["fit"]
        cases["fit"] = ("fit", dict(
            proj=host(ftp), positions=positions, rotations=rotations,
            cam=tcam, targets=targets, shape=FIT_SHAPE, steps=FIT_STEPS))
        cases["fit_grad"] = ("fit_grad", dict(
            proj=host(ftp), positions=positions, rotations=rotations,
            cam=tcam, targets=targets, shape=FIT_SHAPE))
    return cases


@functools.lru_cache(maxsize=None)
def _launch(n):
    """Every case on n gloo ranks (one launch): each rank's results."""
    return run_ranks(functools.partial(bodies.run_cases, _rank_cases(n)), n,
                     backend="gloo", device_type="cpu",
                     timeout_s=LAUNCH_TIMEOUT_S)


def _agreed(n, name):
    """Case `name`'s result, the same on every rank."""
    results = _launch(n)
    first = results[0][name]
    for rank, res in enumerate(results[1:], 1):
        assert np.array_equal(res[name], first), (name, rank)
    return first


def _jmesh(names, n, shape=None):
    return jsharding.make_mesh(names, shape=shape,
                               devices=jax.devices()[:n])


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_view_tiled_matches_lif_tpu_and_one_rank(n):
    """render_view_tiled: n row bands of a 32x48 view, all-gathered."""
    inp = _inputs()
    (jp, tp), (jcams, tcams) = inp["proj"], inp["tiled_cam"]
    got = _agreed(n, "tiled")
    want = np.asarray(jsharding.render_view_tiled(
        jp, jcams[0], _jmesh(("tile",), n)))
    assert got.shape == (H, W, 4)
    assert np.abs(got - want).max() <= 1e-5
    single = lif_tpu_torch.render_mono_view(tp, tcams[0], mask_mode="none")
    assert np.abs(got - single.numpy()).max() <= 1e-6


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_trajectory_sharded_matches_lif_tpu_and_one_rank(n):
    """render_trajectory_sharded: 8 exact-march frames split n ways, held
    to lif_tpu's and to the port's render_mono at the same float64 world
    poses (render_mono_view would take the float32 poses of a Camera)."""
    inp = _inputs()
    jp, tp = inp["proj"]
    positions = inp["traj"]
    rotations = np.stack([np.eye(3)] * len(positions))
    got = _agreed(n, "trajectory")
    want = np.asarray(jsharding.render_trajectory_sharded(
        jp, positions, rotations, inp["template"][0][0],
        _jmesh(("frame",), n)))
    assert got.shape == (len(positions), H, W, 4)
    # XLA contracts the march's multiply-adds into FMAs, the port rounds
    # each product: 3 of the 49152 values differ by 1e-5 to 2.1e-5
    assert np.abs(got - want).max() <= 3e-5
    assert np.abs(got[0] - got[-1]).max() > 0.01
    template = inp["template"][1][0]
    for frame, p, r in zip(got, positions, rotations):
        single = traycast.render_mono(
            *trenderer._view_args(tp, p, r), float(template.focal_px),
            template.skew, (0.0, 0.0, 0.0, 0.0), out_w=W, out_h=H,
            num_layers=1, mask_mode="none")
        assert np.abs(frame - single.numpy()).max() <= 1e-6


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", WORLD_SIZES)
def test_fast_trajectory_sharded_matches_lif_tpu_and_one_rank(n, family):
    """render_fast_trajectory_sharded on lateral, orbit (a rotation tier),
    2-layer LDI and skewed poses: each rank plans the whole batch and
    renders its block, so the frames equal the port's unsharded
    render_fast_batch, and lif_tpu's sharded fast path to 2e-4."""
    jp, tp, positions, rotations, jcam, tcam = _fast_case(family)
    got = _agreed(n, f"fast_{family}")
    want = np.asarray(jsharding.render_fast_trajectory_sharded(
        jp, positions, jcam, _jmesh(("frame",), n),
        cameras_rotations=rotations))
    assert got.shape == (len(positions), tcam.height, tcam.width, 4)
    assert np.abs(got - want).max() <= 2e-4
    _, tcams = _cams(tcam.width, tcam.height, positions, rotations,
                     skew=tcam.skew)
    ref, tiers = lif_tpu_torch.render_fast_batch(tp, tcams,
                                                 return_tiers=True)
    assert np.abs(got - ref.numpy()).max() <= 1e-6
    if family == "orbit":
        assert "march" not in tiers, tiers


@pytest.mark.parametrize("n", WORLD_SIZES)
def test_fused_projectors_view_and_tile_match_one_process(n):
    """render_fused_projectors on an n-view mesh (one projector a rank)
    and on an (n/2 view, 2 tile) mesh, each against the port's
    one-process fusion of the same projectors at 1e-6 (which
    tests/test_torch_fusion.py holds to lif_tpu's shard_map fusion)."""
    inp = _inputs()
    nv = n // 2 if n > 1 else 1
    (tcam,) = inp["fused_cam"][1]
    tps = [t for _, t in inp["fused"]]
    views, tiles = _agreed(n, "fused")
    one_views = tsharding.render_fused_projectors(
        tps[:n], tcam).numpy()
    one_tiles = tsharding.render_fused_projectors(
        tps[:nv], tcam).numpy()
    assert views.shape == tiles.shape == (H, W, 4)
    assert np.abs(views - one_views).max() <= 1e-6
    assert np.abs(tiles - one_tiles).max() <= 1e-6


@pytest.mark.parametrize("n", WORLD_SIZES[1:])
def test_sharded_errors_match_lif_tpu(n):
    """A batch, a height or a projector count that does not divide over
    the axis raises ValueError with lif_tpu's text."""
    inp = _inputs()
    jp = inp["proj"][0]
    jcam = inp["template"][0][0]
    got = _agreed(n, "errors")
    bad = np.zeros((n + 1, 3))
    odd = lif_tpu.Camera.create(W, n * 4 + 1, focal_px=0.78 * W)
    calls = {
        "tiled": lambda: jsharding.render_view_tiled(
            jp, odd, _jmesh(("tile",), n)),
        "trajectory": lambda: jsharding.render_trajectory_sharded(
            jp, bad, np.stack([np.eye(3)] * (n + 1)), jcam,
            _jmesh(("frame",), n)),
        "fast": lambda: jsharding.render_fast_trajectory_sharded(
            jp, bad + [0.01, 0.0, 0.0], jcam, _jmesh(("frame",), n)),
        "fused": lambda: jsharding.render_fused_projectors(
            [jp] * (n + 1), jcam, _jmesh(("view",), n)),
    }
    assert set(got) == set(calls)
    for name, call in calls.items():
        with pytest.raises(ValueError) as err:
            call()
        assert got[name] == str(err.value), name


def test_sharded_fit_matches_lif_tpu_and_one_process():
    """fit_projector(mesh=...) on a (data, tile) = (4, 2) mesh: 8 poses, 2
    a data rank, 12 of 24 rows a tile rank; 5 Adam steps."""
    proj_bad, tp, positions, rotations, cam, tcam, targets, _ = _inputs()[
        "fit"]
    results = _launch(FIT_SHAPE[0] * FIT_SHAPE[1])
    fits = [r["fit"] for r in results]
    for other in fits[1:]:
        for key in ("disp", "position_delta", "rotation_delta"):
            assert np.array_equal(other[key], fits[0][key]), key
        assert other["losses"] == fits[0]["losses"]
    got = np.array(fits[0]["losses"])
    _, want = jfit.fit_projector(
        proj_bad, positions, rotations, cam, targets, steps=FIT_STEPS,
        num_steps=12, mesh=_jmesh(("data", "tile"), 8, FIT_SHAPE))
    np.testing.assert_allclose(got, np.array(want), rtol=2e-4)
    one, hist = tfit.fit_projector(tp, positions, rotations, tcam, targets,
                                   steps=FIT_STEPS, num_steps=12)
    np.testing.assert_allclose(got[:3], np.array(hist[:3]), rtol=1e-5)
    assert not np.array_equal(fits[0]["disp"], tp.disp.numpy())
    for key, param in zip(("disp", "position_delta", "rotation_delta"), one):
        assert np.abs(fits[0][key] - param.numpy()).max() < 1e-5, key


def test_sharded_fit_gradient_is_the_global_mean_gradient():
    """make_train_step(groups=) on the (data, tile) = (4, 2) mesh, one SGD
    step: every rank applies the gradient of the global mean loss, the
    one-process gradient on all 8 poses and 24 rows (a SUM left undivided
    or counted twice over the two groups would be 8 or 64 times too
    large, which Adam's update would hide)."""
    _, tp, positions, rotations, _, tcam, targets, _ = _inputs()["fit"]
    grads = [r["fit_grad"] for r in _launch(FIT_SHAPE[0] * FIT_SHAPE[1])]
    for other in grads[1:]:
        for got, first in zip(other, grads[0]):
            assert np.array_equal(got, first)
    model = tfit.SceneFit(
        tfit.FitParams(tp.disp, torch.zeros(3), torch.zeros(3)),
        tfit.static_projector(tp, tcam), tcam.width, tcam.height,
        tp.num_layers, 12)
    rel_p, rel_r = tfit.relative_poses(tp, positions, rotations)
    loss = tfit.l2_loss(model(torch.as_tensor(rel_p), torch.as_tensor(rel_r)),
                        torch.as_tensor(targets))
    loss.backward()
    for got, param in zip(grads[0], model.parameters()):
        want = param.grad.numpy()
        assert np.abs(want).max() > 0.0
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
