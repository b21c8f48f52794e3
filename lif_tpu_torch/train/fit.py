"""Differentiable-rendering optimization: refine depth and pose by gradient.

The counterpart of lif_tpu.train.fit. The soft plane sweep
(ops/sweep.render_sweep) is a chain of differentiable torch ops, so scene
parameters (the inverse-depth maps, a pose correction) can be fitted to
target photographs by gradient descent: scene fitting and pose
registration. SceneFit holds the parameters as nn.Parameters and
fit_projector runs torch.optim.Adam over them on the projector's device.

Adam: optax.adam (lif_tpu's optimizer) and torch.optim.Adam share the
defaults (b1 = 0.9, b2 = 0.999, eps = 1e-8 added outside the square root,
no weight decay) and the update: with m_t = b1 m + (1 - b1) g and
v_t = b2 v + (1 - b2) g^2,

    p <- p - lr * (m_t / (1 - b1^t)) / (sqrt(v_t / (1 - b2^t)) + eps).

The two evaluate it in another order, so the parameters agree to float32
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.pose import relative_view_pose
from ..ops import sweep as _sweep
from .losses import l2_loss

__all__ = ["FitParams", "SceneFit", "clip01", "fit_params_from_arrays",
           "fit_projector", "make_train_step", "relative_poses",
           "render_with_params", "static_projector"]


class FitParams(NamedTuple):
    """Learnable scene parameters."""

    disp: torch.Tensor  # (L, H, W) inverse-depth maps (the main unknowns)
    position_delta: torch.Tensor  # (3,) pose correction
    rotation_delta: torch.Tensor  # (3,) axis-angle pose correction


def fit_params_from_arrays(disp, position_delta, rotation_delta,
                           device=None) -> FitParams:
    """The port's FitParams holding the same values as lif_tpu's FitParams
    (or any three arrays): float32 tensors on `device` (None: the card)."""
    dev = torch.device("cuda" if device is None else device)
    return FitParams(*(
        torch.as_tensor(np.array(a, dtype=np.float32), device=dev)
        for a in (disp, position_delta, rotation_delta)
    ))


class _Clip01(torch.autograd.Function):
    """clamp(x, 0, 1) with jnp.clip's derivative: 1 inside, 0 outside and
    0.5 at exactly 0 or 1 (jnp.clip is a max then a min, and each splits
    a tie evenly; torch.clamp passes the whole gradient there). A fit
    starts from a clipped perturbation, so many texels sit on a bound."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp(0.0, 1.0)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        inside = ((x > 0.0) & (x < 1.0)).to(grad.dtype)
        tie = ((x == 0.0) | (x == 1.0)).to(grad.dtype)
        return grad * (inside + 0.5 * tie)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """clamp(x, 0, 1) with jnp.clip's derivative (_Clip01)."""
    return _Clip01.apply(x)


def _rodrigues(w: torch.Tensor) -> torch.Tensor:
    """exp of an axis-angle vector -> rotation matrix (differentiable)."""
    theta = torch.sqrt(torch.sum(w * w) + 1e-12)
    k = w / theta
    zero = torch.zeros_like(theta)
    kx = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)


def render_with_params(
    params: FitParams,
    static_proj: dict,
    rel_positions,
    rel_rotations,
    out_w: int,
    out_h: int,
    num_layers: int,
    num_steps: int = 12,
    full_h: int | None = None,
    row_start: int = 0,
):
    """Render a BATCH of frames from the learnable parameters.

    rel_positions (B, 3) / rel_rotations (B, 3, 3) are base camera-local
    projector poses (shader convention) on the parameters' device; the
    learned pose delta is applied on top. The batch broadcasts through
    the sweep. Returns linear light (B, out_h, out_w, 3): with full_h
    set, the rows [row_start, row_start + out_h) of the full_h-row
    GL-oriented image (a tile-sharded fit's band).

    The SOFT plane sweep, not the hard march: the march's surface
    crossings are discrete decisions with exactly zero gradient with
    respect to the depth map; the sweep's sigmoid occupancy is
    differentiable."""
    d_rot = _rodrigues(params.rotation_delta)
    rot = torch.einsum("ij,bjk->bik", d_rot, rel_rotations)
    pos = rel_positions + params.position_delta[None, :]
    img = _sweep.render_sweep(
        static_proj["rgb"], clip01(params.disp), static_proj["mask"],
        static_proj["layer_res"], static_proj["invz_min"],
        static_proj["invz_max"], static_proj["focal"], static_proj["skew"],
        pos, rot, static_proj["f2"], static_proj["skew2"],
        np.zeros(4, np.float32), out_w=out_w, out_h=out_h,
        num_layers=num_layers, num_planes=num_steps, to_srgb=False,
        full_h=full_h, row_start=row_start,
    )
    return img[..., :3]


class SceneFit(nn.Module):
    """The trainable scene: the three FitParams as nn.Parameters (on the
    device of the FitParams given), rendered through render_with_params
    against a fixed projector (`static_proj`: textures on the device, host
    fields), as whole images or as the band of rows [row_start, row_start
    + out_h) of full_h-row images."""

    def __init__(self, params: FitParams, static_proj: dict, out_w: int,
                 out_h: int, num_layers: int, num_steps: int = 12,
                 full_h: int | None = None, row_start: int = 0):
        super().__init__()
        self.disp = nn.Parameter(params.disp.detach().clone())
        self.position_delta = nn.Parameter(
            params.position_delta.detach().clone())
        self.rotation_delta = nn.Parameter(
            params.rotation_delta.detach().clone())
        self.static_proj = static_proj
        self.out_w, self.out_h = out_w, out_h
        self.num_layers, self.num_steps = num_layers, num_steps
        self.full_h, self.row_start = full_h, row_start

    def params(self) -> FitParams:
        """The current parameters, detached copies."""
        return FitParams(self.disp.detach().clone(),
                         self.position_delta.detach().clone(),
                         self.rotation_delta.detach().clone())

    def forward(self, rel_positions, rel_rotations):
        return render_with_params(
            FitParams(self.disp, self.position_delta, self.rotation_delta),
            self.static_proj, rel_positions, rel_rotations, self.out_w,
            self.out_h, self.num_layers, self.num_steps, self.full_h,
            self.row_start,
        )


def make_train_step(model: SceneFit, optimizer: torch.optim.Optimizer,
                    groups=()):
    """The train step of `model` under `optimizer`: (rel_positions,
    rel_rotations, targets) -> the loss at the parameters before the
    update (a 0-d tensor), after one optimizer step in place (lif_tpu's
    (state, ...) -> (state, loss)).

    `groups`: torch.distributed process groups that together span the
    ranks of a sharded step, each rank holding an equal shard of the
    batch. The gradients (packed into one buffer) and the loss are then
    all-reduced with SUM over each group in turn and divided by the number
    of ranks, so that every rank applies the gradient of the global mean
    loss and reports that loss."""
    ranks = 1
    for group in groups:
        ranks *= dist.get_world_size(group)

    def mean_over_ranks(t):
        for group in groups:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t / ranks

    def train_step(rel_positions, rel_rotations, targets):
        optimizer.zero_grad(set_to_none=True)
        loss = l2_loss(model(rel_positions, rel_rotations), targets)
        loss.backward()
        if groups:
            params = list(model.parameters())
            flat = mean_over_ranks(torch.cat(
                [p.grad.reshape(-1) for p in params]))
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
            loss = mean_over_ranks(loss.detach().clone())
        optimizer.step()
        return loss.detach()

    return train_step


def relative_poses(projector, cameras_positions, cameras_rotations):
    """Camera-local projector poses (B, 3) and (B, 3, 3), float32, from the
    float64 host poses (lif_tpu's loop)."""
    b = len(cameras_positions)
    rel_p = np.zeros((b, 3), np.float32)
    rel_r = np.zeros((b, 3, 3), np.float32)
    for i in range(b):
        rel_p[i], rel_r[i] = relative_view_pose(
            np.asarray(projector.position, np.float64),
            np.asarray(projector.rotation, np.float64),
            np.asarray(cameras_positions[i], np.float64),
            np.asarray(cameras_rotations[i], np.float64),
        )
    return rel_p, rel_r


def static_projector(projector, camera_template) -> dict:
    """render_with_params' fixed inputs of a projector seen through a
    camera template: textures on the projector's device, ranges divided
    by the baseline in float32 (as lif_tpu divides them)."""
    baseline = np.float32(projector.baseline)
    return dict(
        rgb=projector.rgb,
        mask=projector.mask,
        layer_res=np.asarray(projector.layer_res, np.float32),
        invz_min=np.asarray(projector.invz_min, np.float32) / baseline,
        invz_max=np.asarray(projector.invz_max, np.float32) / baseline,
        focal=np.asarray(projector.focal, np.float32),
        skew=np.asarray(projector.skew, np.float32),
        f2=np.float32(camera_template.focal_px),
        skew2=np.asarray(camera_template.skew, np.float32),
    )


def fit_projector(
    projector,
    cameras_positions,
    cameras_rotations,
    camera_template,
    targets,
    steps: int = 50,
    learning_rate: float = 2e-3,
    num_steps: int = 12,
    mesh=None,
    data_axis: str = "data",
    tile_axis: str | None = "tile",
):
    """Fit a projector's depth maps (+ a pose delta) to target images with
    Adam on the projector's device (the card unless the projector lives
    elsewhere); the targets are moved there.

    targets: (B, H, W, 3) linear light, GL-oriented, one per camera
    (world positions (B, 3), rotations (B, 3, 3)); camera_template gives
    the shared intrinsics. num_steps: the soft sweep's planes.

    mesh: a torch.distributed DeviceMesh (parallel.sharding.make_mesh),
    every rank calling with the same arguments (lif_tpu's data- and
    tile-sharded step). The parameters are replicated; the rank at
    (d, t) of the (data_axis, tile_axis) mesh renders poses
    [d B/n_data, (d+1) B/n_data) and rows [t H/n_tile, (t+1) H/n_tile)
    and takes its loss over that shard; gradients and loss are averaged
    over the ranks (make_train_step), so each step is the one-process
    step on the global mean loss and every rank applies the same update.
    A tile_axis the mesh lacks (or None) shards the poses only. B must
    divide by the data axis and H by the tile axis.

    Returns (fitted FitParams, list of the losses, one per step, each at
    the parameters before that step's update)."""
    dev = projector.device
    rel_p, rel_r = relative_poses(projector, cameras_positions,
                                   cameras_rotations)
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    full_h, row_start, groups = None, 0, ()
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(
                "mesh must be a torch.distributed DeviceMesh "
                "(parallel.sharding.make_mesh)")
        from ..parallel.sharding import _axis

        n_data, d, data_group = _axis(mesh, data_axis)
        n_tile, t, tile_group = (
            _axis(mesh, tile_axis)
            if tile_axis is not None and tile_axis in mesh.mesh_dim_names
            else (1, 0, None))
        b, h = len(rel_p), camera_template.height
        if b % n_data:
            raise ValueError(
                f"{b} poses not divisible by the {n_data}-device "
                f"'{data_axis}' axis")
        if h % n_tile:
            raise ValueError(f"height {h} not divisible by {n_tile} tiles")
        poses = slice(d * b // n_data, (d + 1) * b // n_data)
        full_h, row_start = h, t * h // n_tile
        rel_p, rel_r = rel_p[poses], rel_r[poses]
        targets = targets[poses, row_start:row_start + h // n_tile]
        groups = tuple(g for g in (data_group, tile_group) if g is not None)
    params = FitParams(projector.disp, torch.zeros(3, device=dev),
                       torch.zeros(3, device=dev))
    model = SceneFit(params, static_projector(projector, camera_template),
                     camera_template.width, targets.shape[1],
                     projector.num_layers, num_steps, full_h, row_start)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate)
    train_step = make_train_step(model, optimizer, groups)
    rel_p = torch.as_tensor(rel_p, device=dev)
    rel_r = torch.as_tensor(rel_r, device=dev)
    losses = [float(train_step(rel_p, rel_r, targets)) for _ in range(steps)]
    return model.params(), losses
