"""Multi-device rendering over torch.distributed: image-tile, frame and
projector parallelism.

The counterpart of lif_tpu.parallel.sharding. lif_tpu runs one program
over a jax Mesh with shard_map; here every rank of a process group runs
these functions (under torchrun, or parallel.launch.run_ranks) with the
same arguments, renders its shard on its own device, and the shards meet
through torch.distributed collectives over the groups of a
torch.distributed DeviceMesh (make_mesh):

  * TILE parallelism: the output framebuffer is split into row bands over
    a mesh axis; each rank ray-marches its band of the same virtual image
    (render_view_tiled), and the bands are all-gathered.
  * FRAME parallelism: a trajectory's poses are split over an axis; each
    rank renders its contiguous block of frames, on the exact march
    (render_trajectory_sharded) or on the production fast path
    (render_fast_trajectory_sharded), and the frames are all-gathered.
  * PROJECTOR (view) parallelism: each rank of the view axis renders its
    own projector; the fused image is the nearest-surface merge across
    the axis with all_reduce (MAX, then SUM) (render_fused_projectors,
    which also runs in one process without a mesh: the oracle of
    render_fused_fast_batch).

Only all_reduce and all_gather are used: gloo implements both for CUDA
tensors too, so several ranks can share one card where NCCL refuses.
Every rank returns the whole result on its own device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG
from ..core.camera import Camera
from ..core.pose import relative_view_pose
from ..models.renderer import (_default_mask_mode, _view_args,
                               render_fast_batch)
from ..ops import raycast as _raycast
from ..ops.composite import finish_over_background, fuse_views

__all__ = [
    "make_mesh",
    "render_fast_trajectory_sharded",
    "render_fused_projectors",
    "render_trajectory_sharded",
    "render_view_tiled",
]


def make_mesh(axis_names=("tile",), shape=None, device_type: str = "cuda"):
    """A torch.distributed DeviceMesh over the ranks of the default process
    group (1-D over all of them by default), with named axes. Needs an
    initialized default process group (torch.distributed's
    init_process_group, as torchrun or parallel.launch.run_ranks set it
    up); device_type is the ranks' device, 'cuda' unless the caller asks
    for 'cpu'."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized default process group "
            "(torch.distributed.init_process_group)")
    if shape is None:
        shape = (dist.get_world_size(),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def _axis(mesh, name: str):
    """(size, this rank's index, process group) of one named mesh axis."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.size(dim), mesh.get_local_rank(name), mesh.get_group(name)


def _gather_cat(part: torch.Tensor, group, n: int) -> torch.Tensor:
    """The axis's parts, equal in shape, concatenated along dim 0 in rank
    order (all_gather)."""
    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part.contiguous(), group=group)
    return torch.cat(parts)


def render_view_tiled(
    projector,
    camera,
    mesh,
    axis_name: str = "tile",
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    **kwargs,
):
    """Render one view on the exact march with the image row-sharded over
    `axis_name`. The textures are replicated: rank i of the axis renders
    rows [i*H/n, (i+1)*H/n) of the GL-oriented image (render_mono's row
    band), and the bands are all-gathered. kwargs go to
    ops.raycast.render_mono (num_steps, feathering, to_srgb). Returns the
    whole (H, W, 4) image on every rank."""
    n, i, group = _axis(mesh, axis_name)
    if camera.height % n:
        raise ValueError(f"height {camera.height} not divisible by {n} tiles")
    tile_h = camera.height // n
    band = _raycast.render_mono(
        *_view_args(projector, camera.position, camera.rotation),
        float(camera.focal_px), camera.skew, background,
        out_w=camera.width, out_h=tile_h, num_layers=projector.num_layers,
        full_h=camera.height, row_start=i * tile_h,
        mask_mode=_default_mask_mode(projector, mask_mode), **kwargs,
    )
    return _gather_cat(band, group, n)


def render_trajectory_sharded(
    projector,
    cameras_positions,
    cameras_rotations,
    camera_template,
    mesh,
    axis_name: str = "frame",
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    **kwargs,
):
    """Render F frames on the exact march, the frames split over
    `axis_name`: rank i of the axis renders its contiguous block of F/n
    world poses (`cameras_positions` (F, 3), `cameras_rotations`
    (F, 3, 3)) with camera_template's intrinsics, one render_mono a
    frame, and the blocks are all-gathered. F must divide by the axis
    size. Returns all (F, H, W, 4) frames on every rank."""
    n, i, group = _axis(mesh, axis_name)
    f = len(cameras_positions)
    if f % n:
        raise ValueError(f"{f} frames not divisible by {n} devices")
    cam = camera_template
    per = f // n
    frames = [
        _raycast.render_mono(
            *_view_args(projector, cameras_positions[j], cameras_rotations[j]),
            float(cam.focal_px), cam.skew, background, out_w=cam.width,
            out_h=cam.height, num_layers=projector.num_layers,
            mask_mode=_default_mask_mode(projector, mask_mode), **kwargs,
        )
        for j in range(i * per, (i + 1) * per)
    ]
    return _gather_cat(torch.stack(frames), group, n)


def render_fast_trajectory_sharded(
    projector,
    cameras_positions,
    camera_template,
    mesh,
    axis_name: str = "frame",
    cameras_rotations=None,
    background=(0.0, 0.0, 0.0, 0.0),
    num_planes: int | None = None,
    feathering: float = 0.1,
    mask_mode: str | None = None,
    to_srgb: bool = True,
    **kwargs,
):
    """The production fast path (models.renderer.render_fast_batch) with
    the frames split over `axis_name`, for every pose family it covers
    (lateral, aligned xyz and zoom, yaw and pitch orbits, general
    rotations, skewed frustums, LDI, the sweep).

    Every rank plans the WHOLE batch as render_fast_batch does (the tier
    plans, snap tables and march windows depend on the batch they are
    made for: a slice planned alone renders other float32 roundings),
    then renders only its contiguous block of F/n poses, in pose chunks of
    at most config.pose_chunk (on CUDA, one launch of each routed kernel
    per layer and chunk of the block); the blocks are all-gathered.

    `cameras_positions` (F, 3) world positions, optional
    `cameras_rotations` (F, 3, 3) (camera_template's otherwise); F must
    divide by the axis size. kwargs go to render_fast_batch (method,
    exact_color, refine, config, ...). Returns all (F, H, W, 4) frames on
    every rank, equal to render_fast_batch's."""
    n, i, group = _axis(mesh, axis_name)
    cam = camera_template
    f = len(cameras_positions)
    if f % n:
        raise ValueError(
            f"{f} poses not divisible by the {n}-device '{axis_name}' axis")
    rots = (
        [np.asarray(cam.rotation, np.float64)] * f
        if cameras_rotations is None
        else [np.asarray(r, np.float64) for r in cameras_rotations]
    )
    cams = [
        Camera.create(
            cam.width, cam.height, focal_px=float(cam.focal_px),
            position=np.asarray(p, np.float64), rotation=r,
            skew=np.asarray(cam.skew),
        )
        for p, r in zip(cameras_positions, rots)
    ]
    per = f // n
    block = render_fast_batch(
        projector, cams, background=background, num_planes=num_planes,
        feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
        _poses=slice(i * per, (i + 1) * per), **kwargs,
    )
    return _gather_cat(block, group, n)


def _view_composite(p, camera, s2x, s2y, fskr2, bg, mode: str,
                    num_steps: int):
    """One projector's FULL LDI stack ray-marched over the (s2x, s2y) grid
    and composited front to back with the reference's mask semantics
    (ops.raycast.cast_view). Returns its premultiplied colour, alpha and
    frontmost hit's inverse depth (0 where nothing was hit). The march
    runs on the baseline-normalized range, so that invz2 is already
    absolute and compares across projectors with other baselines."""
    pos, rot = relative_view_pose(p.position, p.rotation, camera.position,
                                  camera.rotation)
    baseline = np.float32(p.baseline)
    acc_a = torch.zeros(s2x.shape, dtype=torch.float32, device=s2x.device)
    acc_rgb = torch.zeros(s2x.shape + (3,), dtype=torch.float32,
                          device=s2x.device)
    front = torch.zeros_like(acc_a)
    for rgba, invz2, _ in _raycast.cast_view(
        p.rgb, p.disp, p.mask, p.layer_res,
        np.asarray(p.invz_min, np.float32) / baseline,
        np.asarray(p.invz_max, np.float32) / baseline,
        p.focal, p.skew, np.asarray(pos, np.float32),
        np.asarray(rot, np.float32), fskr2, s2x, s2y, bg[:3],
        p.num_layers, 0.1, num_steps, mode,
    ):
        a = rgba[..., 3]
        acc_rgb = (acc_rgb
                   + (1.0 - acc_a[..., None]) * a[..., None] * rgba[..., :3])
        new_hit = (a > 0.0) & (front == 0.0)
        front = torch.where(new_hit, invz2, front)
        acc_a = acc_a + (1.0 - acc_a) * a
    return acc_rgb, acc_a, front


def _all_reduce(op, group):
    """A reduction over the ranks of `group` (all_reduce with `op`) of a
    copy of its argument, for ops.composite.fuse_views."""
    def reduce(t):
        t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    return reduce


def render_fused_projectors(
    projectors,
    camera,
    mesh=None,
    axis_name: str = "view",
    tile_axis: str | None = None,
    background=(0.0, 0.0, 0.0, 0.0),
    mask_mode: str | None = None,
    to_srgb: bool = True,
    fuse_tol: float | None = None,
    num_steps: int = _raycast.NUM_STEPS,
):
    """Fuse several projectors into one view on the exact march. Returns
    (H, W, 4) (GL-oriented) on the projectors' device, on every rank.

    Each projector's FULL LDI stack is ray-marched and composited front to
    back, keeping its frontmost hit's inverse depth; the views are merged
    at the frontmost surface with the triangular weights of
    ops.composite.fusion_weights. This is the multi-projector fusion
    the reference lacks (it renders only the first projector;
    HoloRenderer.ts:186-189), and the oracle of render_fused_fast_batch.

    mesh None: one process renders every view in turn and the merge
    reduces over a stacked view axis. With a DeviceMesh (make_mesh): rank
    v of `axis_name` renders projectors[v] (there must be one projector
    per rank of the axis) and the merge runs with all_reduce over the
    axis's group; `tile_axis`, a second axis, splits the image into row
    bands as well (each rank marches its projector over its band; the
    fused bands are all-gathered over the tile group).

    As in lif_tpu: the projectors must share their dimensions; the edge
    feathering is fixed at 0.1 and the miss colour is background[:3];
    mask_mode None takes the reference default per projector ('multiply'
    for an LDI, else 'none'), and where those differ every view uses
    'multiply' (lif_tpu traces one program for all views). lif_tpu pads
    every projector to the largest layer count with dead layers (alpha
    gated to 0); a dead layer leaves the composite as it is, so here a
    projector marches its own layers only."""
    p0 = projectors[0]
    for p in projectors:
        if (p.height, p.width) != (p0.height, p0.width):
            raise ValueError("fused projectors must share dimensions")
    modes = {_default_mask_mode(p, mask_mode) for p in projectors}
    mode = modes.pop() if len(modes) == 1 else "multiply"
    device = p0.device
    bg = torch.as_tensor(np.asarray(background, np.float32), device=device)
    fskr2 = _raycast.target_transform(float(camera.focal_px), camera.width,
                                      camera.height, camera.skew)
    tol = DEFAULT_CONFIG.fuse_tol if fuse_tol is None else fuse_tol
    if mesh is None:
        s2x, s2y = _raycast._pixel_grid(camera.width, camera.height, device)
        views = [_view_composite(p, camera, s2x, s2y, fskr2, bg, mode,
                                 num_steps) for p in projectors]
        color, alpha = fuse_views(*(torch.stack(v) for v in zip(*views)),
                                   tol)
        return finish_over_background(color, alpha, bg, to_srgb=to_srgb)

    n, v, view_group = _axis(mesh, axis_name)
    if len(projectors) != n:
        raise ValueError(f"need exactly {n} projectors for a {n}-way mesh")
    n_tiles, t, tile_group = (_axis(mesh, tile_axis) if tile_axis is not None
                              else (1, 0, None))
    if camera.height % n_tiles:
        raise ValueError(
            f"height {camera.height} not divisible by {n_tiles} tiles")
    tile_h = camera.height // n_tiles
    s2x, s2y = _raycast._pixel_grid(camera.width, tile_h, device,
                                    full_h=camera.height,
                                    row_start=t * tile_h)
    color, alpha = fuse_views(
        *_view_composite(projectors[v], camera, s2x, s2y, fskr2, bg, mode,
                         num_steps), tol,
        _all_reduce(dist.ReduceOp.MAX, view_group),
        _all_reduce(dist.ReduceOp.SUM, view_group))
    band = finish_over_background(color, alpha, bg, to_srgb=to_srgb)
    return band if tile_group is None else _gather_cat(band, tile_group,
                                                       n_tiles)
