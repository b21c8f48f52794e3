"""Rank bodies of the multi-rank tests (tests/test_torch_parallel.py).

Each rank of parallel.launch.run_ranks imports this module by name in a
fresh interpreter, so it imports torch and lif_tpu_torch only: the test
process has JAX set up on a virtual 8-device CPU mesh, and no rank may
import it. It is not collected (no test_ prefix).

run_cases(cases) runs every case of one launch on the ranks' default
process group (gloo, CPU tensors) and returns each case's result as
numpy. A case is (kind, keyword arguments); projectors cross the process
boundary in host form (to_host: their textures as numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from lif_tpu_torch.parallel import sharding
from lif_tpu_torch.train import fit


def to_host(projector):
    """A port Projector with its textures as numpy, for pickling."""
    return dataclasses.replace(projector, rgb=projector.rgb.numpy(),
                               disp=projector.disp.numpy(),
                               mask=projector.mask.numpy())


def _from_host(projector):
    return dataclasses.replace(
        projector, rgb=torch.as_tensor(projector.rgb),
        disp=torch.as_tensor(projector.disp),
        mask=torch.as_tensor(projector.mask))


def _tiled(meshes, proj, cam):
    return sharding.render_view_tiled(_from_host(proj), cam,
                                      meshes(("tile",)))


def _trajectory(meshes, proj, positions, rotations, cam):
    return sharding.render_trajectory_sharded(
        _from_host(proj), positions, rotations, cam, meshes(("frame",)))


def _fast(meshes, proj, positions, cam, rotations=None, **kw):
    return sharding.render_fast_trajectory_sharded(
        _from_host(proj), positions, cam, meshes(("frame",)),
        cameras_rotations=rotations, **kw)


def _fused(meshes, projs, cam, **kw):
    """The fused render on an n-view mesh (one projector a rank) and on an
    (n/2 view, 2 tile) mesh with the first n/2 projectors (on one rank,
    a 1 x 1 mesh)."""
    n = dist.get_world_size()
    projs = [_from_host(p) for p in projs]
    views = sharding.render_fused_projectors(projs[:n], cam,
                                             meshes(("view",)), **kw)
    nv, nt = (n // 2, 2) if n > 1 else (1, 1)
    tiles = sharding.render_fused_projectors(
        projs[:nv], cam, meshes(("view", "tile"), (nv, nt)),
        tile_axis="tile", **kw)
    return np.stack([views.numpy(), tiles.numpy()])


def _fit(meshes, proj, positions, rotations, cam, targets, shape, steps):
    params, losses = fit.fit_projector(
        _from_host(proj), positions, rotations, cam, targets, steps=steps,
        num_steps=12, mesh=meshes(("data", "tile"), shape))
    return {"losses": losses, "disp": params.disp.numpy(),
            "position_delta": params.position_delta.numpy(),
            "rotation_delta": params.rotation_delta.numpy()}


def _fit_grad(meshes, proj, positions, rotations, cam, targets, shape):
    """One make_train_step(groups=) step under SGD on a (data, tile) mesh,
    this rank's shard cut here (its block of poses, its band of rows):
    the gradient the rank applied, per parameter, after the all-reduce."""
    mesh = meshes(("data", "tile"), shape)
    (n_data, n_tile), (d, t) = shape, mesh.get_coordinate()
    proj = _from_host(proj)
    rel_p, rel_r = fit.relative_poses(proj, positions, rotations)
    per, rows = len(rel_p) // n_data, cam.height // n_tile
    poses, band = slice(d * per, (d + 1) * per), slice(t * rows,
                                                       (t + 1) * rows)
    model = fit.SceneFit(
        fit.FitParams(proj.disp, torch.zeros(3), torch.zeros(3)),
        fit.static_projector(proj, cam), cam.width, rows, proj.num_layers,
        12, cam.height, t * rows)
    step = fit.make_train_step(
        model, torch.optim.SGD(model.parameters(), lr=1.0),
        (mesh.get_group("data"), mesh.get_group("tile")))
    step(torch.as_tensor(rel_p[poses]), torch.as_tensor(rel_r[poses]),
         torch.as_tensor(targets[poses, band]))
    return [p.grad.numpy() for p in model.parameters()]


def _errors(meshes, proj, cam, cam_odd_h):
    """The messages of the sharded functions' input errors on this mesh:
    (name, message) pairs."""
    n = dist.get_world_size()
    frames = meshes(("frame",))
    host = _from_host(proj)
    bad = np.zeros((n + 1, 3))
    rots = np.stack([np.eye(3)] * (n + 1))
    calls = {
        "tiled": lambda: sharding.render_view_tiled(host, cam_odd_h,
                                                    meshes(("tile",))),
        "trajectory": lambda: sharding.render_trajectory_sharded(
            host, bad, rots, cam, frames),
        "fast": lambda: sharding.render_fast_trajectory_sharded(
            host, bad + [0.01, 0.0, 0.0], cam, frames),
        "fused": lambda: sharding.render_fused_projectors(
            [host] * (n + 1), cam, meshes(("view",))),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
        except ValueError as err:
            out[name] = str(err)
    return out


def fail_on_rank_1():
    """Rank 1 raises; the others wait in a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank body failed on purpose")
    dist.barrier()


def hang_on_rank_1():
    """Rank 1 waits in a collective that rank 0, returning at once, never
    joins."""
    if dist.get_rank() == 1:
        dist.all_reduce(torch.zeros(1))


KINDS = {"tiled": _tiled, "trajectory": _trajectory, "fast": _fast,
         "fused": _fused, "fit": _fit, "fit_grad": _fit_grad,
         "errors": _errors}


def run_cases(cases: dict) -> dict:
    """Every case of a launch on the default process group, each mesh made
    once: {name: result}, tensors as numpy."""
    made = {}

    def meshes(names, shape=None):
        key = (names, shape)
        if key not in made:
            made[key] = sharding.make_mesh(names, shape, device_type="cpu")
        return made[key]

    out = {}
    for name, (kind, kw) in cases.items():
        res = KINDS[kind](meshes, **kw)
        out[name] = res.numpy() if isinstance(res, torch.Tensor) else res
    return out
