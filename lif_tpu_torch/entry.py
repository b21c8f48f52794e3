"""Entry points: a one-process forward check and a multi-rank dry run.

The counterpart of __graft_entry__.py. entry() is one forward render of
the exact mono-LDI ray march at its shapes; dryrun_multichip(n) runs, on
n ranks started by parallel.launch.run_ranks, one sharded fit step on a
(data, tile) mesh and the 256x320 fused render over an n-view mesh.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dryrun_multichip", "entry"]


def entry(device="cuda"):
    """(fn, example_args): one forward render of the exact mono-LDI ray
    march (ops.raycast.render_mono) at 256x320 with two layers and 16
    steps, the textures on `device` (the card unless the caller asks for
    the CPU). fn(*example_args) returns the (256, 320, 4) image."""
    from .ops import raycast

    h, w, layers = 256, 320, 2
    rng = np.random.default_rng(0)
    rgb = torch.as_tensor(rng.random((layers, h, w, 3), dtype=np.float32),
                          device=device)
    disp = torch.as_tensor(rng.random((layers, h, w), dtype=np.float32),
                           device=device)
    mask = torch.as_tensor(np.ones((layers, h, w), np.float32),
                           device=device)
    layer_res = np.asarray([[w, h]] * layers, np.float32)
    izmin = np.asarray([2.0, 1.0], np.float32)
    izmax = np.asarray([0.2, 0.05], np.float32)
    focal = np.asarray([0.78 * w] * layers, np.float32)
    skew = np.zeros(2, np.float32)
    c1 = np.asarray([0.05, 0.0, 0.02], np.float32)
    rot = np.eye(3, dtype=np.float32)
    bg = np.zeros(4, np.float32)

    def forward(rgb, disp, mask, layer_res, izmin, izmax, focal, skew, c1,
                rot, bg):
        return raycast.render_mono(
            rgb, disp, mask, layer_res, izmin, izmax, focal, skew, c1, rot,
            float(np.float32(0.78 * w)), skew, bg, out_w=w, out_h=h,
            num_layers=layers, num_steps=16,
        )

    return forward, (rgb, disp, mask, layer_res, izmin, izmax, focal, skew,
                     c1, rot, bg)


def _dryrun_rank(device_type: str) -> dict:
    """One rank of the dry run (see dryrun_multichip). Returns the fit's
    loss, the fused image's shape, device type and finiteness, and the
    largest difference between the fused render in the two projector
    orders."""
    import torch.distributed as dist

    from .core.camera import Camera
    from .models.projector import projector_from_arrays
    from .parallel.sharding import make_mesh, render_fused_projectors
    from .train import fit

    n_devices = dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    tile = 2 if n_devices % 2 == 0 else 1
    data = n_devices // tile
    mesh = make_mesh(("data", "tile"), shape=(data, tile),
                     device_type=device_type)
    rng = np.random.default_rng(0)
    h, w = 8 * tile, 16
    b = 2 * data
    projector = projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        rng.random((h, w)).astype(np.float32),
        focal_px=0.78 * w, invz_min=2.0, invz_max=0.2, baseline=1.0,
        device=device,
    )
    cam = Camera.create(w, h, focal_px=0.78 * w)
    positions = np.stack([[0.02 * i, 0.0, 0.0] for i in range(b)])
    rotations = np.stack([np.eye(3)] * b)
    targets = rng.random((b, h, w, 3)).astype(np.float32)
    params, losses = fit.fit_projector(
        projector, positions, rotations, cam, targets, steps=1, num_steps=6,
        mesh=mesh,
    )
    if not np.isfinite(losses[0]) or tuple(params.disp.shape) != (1, h, w):
        raise RuntimeError(f"sharded fit step: losses {losses}, disp "
                           f"{tuple(params.disp.shape)}")

    # the 256x320 fused render over an n-view mesh, unchanged when the
    # projector-to-rank order is reversed (the merge is a symmetric
    # reduction)
    vmesh = make_mesh(("view",), shape=(n_devices,), device_type=device_type)
    hf, wf = 256, 320
    projs = [
        projector_from_arrays(
            rng.random((hf, wf, 3)).astype(np.float32),
            rng.random((hf, wf)).astype(np.float32),
            focal_px=0.78 * wf, invz_min=2.0, invz_max=0.2, baseline=1.0,
            position=(0.01 * i, 0.0, 0.0), device=device,
        )
        for i in range(n_devices)
    ]
    cam_f = Camera.create(wf, hf, focal_px=0.78 * wf,
                          position=[0.02, 0.0, 0.0])
    fused = render_fused_projectors(projs, cam_f, vmesh, num_steps=8)
    fused_rev = render_fused_projectors(projs[::-1], cam_f, vmesh,
                                        num_steps=8)
    return {
        "loss": losses[0],
        "shape": tuple(fused.shape),
        "device": fused.device.type,
        "finite": bool(torch.isfinite(fused).all()),
        "order_err": float((fused - fused_rev).abs().max()),
    }


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     backend: str | None = None,
                     timeout_s: float = 600.0) -> list:
    """One sharded training step (the soft-sweep scene fit on a (data,
    tile) mesh, tile 2 when n_devices is even) and the 256x320 fused
    render of n_devices projectors over an n-view mesh, on n_devices ranks
    (parallel.launch.run_ranks), on the cards unless device_type is
    'cpu'. backend None is gloo on the CPU; on 'cuda' it is NCCL when
    there is a card for every rank, else gloo on CUDA tensors (the ranks
    share the cards, which NCCL refuses). Raises when a step fails, the
    fused image is not (256, 320, 4) and finite, or it changes by more
    than 1e-5 when the projector-to-rank order is reversed. Returns each
    rank's record."""
    from functools import partial

    from .parallel.launch import run_ranks

    if backend is None:
        backend = ("nccl" if device_type == "cuda"
                   and torch.cuda.device_count() >= n_devices else "gloo")
    records = run_ranks(partial(_dryrun_rank, device_type), n_devices,
                        backend=backend, device_type=device_type,
                        timeout_s=timeout_s)
    for rec in records:
        if rec["shape"] != (256, 320, 4) or not rec["finite"]:
            raise RuntimeError(f"fused dry run: {rec}")
        if rec["order_err"] > 1e-5:
            raise RuntimeError(
                "fused merge depends on the projector->rank assignment order "
                f"(max abs diff {rec['order_err']:.2e})")
    return records


if __name__ == "__main__":
    fn, args = entry()
    print("forward:", tuple(fn(*args).shape))
    print("dryrun:", dryrun_multichip(max(torch.cuda.device_count(), 1)))
