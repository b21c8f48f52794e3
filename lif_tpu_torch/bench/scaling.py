"""The tile-sharded exact march over 1..8 ranks and config 4's fused
oracle, on one CUDA card (the port of bench_scaling.py).

Run by bench_configs_torch.py as a subprocess, or from the repository
root: ``python3 bench_scaling_torch.py --fused PATH [--preset
full|smoke|tiny] [--seed N] [--device cuda|cpu]``. Its last stdout line
is one JSON object:

- tile sharding: one w4 x h4 render_view_tiled of the seeded scene
  (resampled from w x h) at x = 0.05 m with num_steps=TILE_STEPS, at each
  world size of the preset's scaling_ranks, every launch through
  parallel.launch.run_ranks (1 rank on NCCL, more on gloo with CUDA
  tensors, all on the one card; gloo on the CPU). 'tile_parity': each
  world size's image against 1 rank's (allclose, atol 1e-4, as
  bench_scaling.py:74). In place of XLA's cost analysis, each rank's share
  of the march is counted from shapes: its tile's rows x w4 x steps over
  1 rank's, a count and no speed-up. The ranks share one card, so their
  wall ms and peak memory are no scaling evidence;
- config 4's oracle: render_fused_projectors(projs, cam, mesh,
  num_steps=conv_steps) of the four projectors in --fused (written by the
  configs runner) over a 4-rank view mesh, at x = 0.05 m, against the
  fast fused frames there, at the default fuse_tol and at 0.1:
  'psnr_default' and 'psnr_0.1' (dB). Where the tile render has a
  4-rank launch, the oracle runs in it, after the tile render.

With --device cpu the wall ms and peak memory sit under 'cpu_smoke'.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time

import numpy as np
import torch

from . import common
from .scenes import scene_projector

TILE_STEPS = 4  # the tile-sharded render's march steps (bench_scaling.py)
TILE_X = 0.05  # m
PARITY_ATOL = 1e-4
ORACLE_RANKS = 4  # one fused projector a rank
RANK_TIMEOUT_S = 900.0
FUSE_TOLS = (("default", None), ("0.1", 0.1))


def scaling_rank(preset: str, seed: int, device_type: str, tile: bool,
                 fused_path: str | None) -> dict:
    """One rank of a launch: the tile-sharded render (tile) and config 4's
    oracle (fused_path), in that order; a launch of ORACLE_RANKS ranks
    does both."""
    out = _tiled(preset, seed, device_type) if tile else {}
    if fused_path is not None:
        out["oracle"] = _oracle(fused_path,
                                common.PRESETS[preset].conv_steps,
                                device_type)
    return out


def _tiled(preset: str, seed: int, device_type: str) -> dict:
    """The tile-sharded render on this rank: the seeded scene resampled
    to w4 x h4 on its device, its band of rows marched and the bands
    all-gathered. Rank 0 returns the image."""
    import torch.distributed as dist

    import lif_tpu_torch as lt
    from lif_tpu_torch.parallel import sharding

    s = common.PRESETS[preset]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    base = scene_projector(lt, seed, s.w, s.h, device=dev)
    base4 = lt.resample_projector(base, s.w4 / s.w, out_w=s.w4, out_h=s.h4,
                                  device=dev)
    cam = lt.Camera.create(s.w4, s.h4, focal_px=float(base4.focal[0]),
                           position=[TILE_X, 0.0, 0.0])
    mesh = sharding.make_mesh(("tile",), device_type=device_type)
    if device_type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    img = sharding.render_view_tiled(base4, cam, mesh, num_steps=TILE_STEPS)
    common.sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    out = {"rows": s.h4 // dist.get_world_size(), "ms": ms,
           "image": img.cpu().numpy() if dist.get_rank() == 0 else None}
    if device_type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _oracle(fused_path: str, conv_steps: int, device_type: str) -> dict:
    """The fused oracle on this rank: the four projectors of `fused_path`
    on its device, rank v marching projector v, merged by
    all_reduce; rank 0 returns the frame at each fuse_tol point."""
    import torch.distributed as dist

    import lif_tpu_torch as lt
    from lif_tpu_torch.parallel import sharding

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    z = np.load(fused_path)
    projs = [lt.projector_from_arrays(
        z["rgb"][i], z["disp"][i], focal_px=float(z["focal"]),
        invz_min=float(z["izmin"]), invz_max=float(z["izmax"]),
        baseline=float(z["baseline"]), position=z["positions"][i],
        device=dev) for i in range(z["rgb"].shape[0])]
    h, w = z["fast_default"].shape[:2]
    cam = lt.Camera.create(w, h, focal_px=float(z["focal"]),
                           position=[TILE_X, 0.0, 0.0])
    mesh = sharding.make_mesh(("view",), device_type=device_type)
    out = {}
    for name, tol in FUSE_TOLS:
        img = sharding.render_fused_projectors(projs, cam, mesh,
                                               num_steps=conv_steps,
                                               fuse_tol=tol)
        if dist.get_rank() == 0:
            out[name] = img.cpu().numpy()
    return out


def _launch(fn, n, device_type):
    from lif_tpu_torch.parallel.launch import run_ranks

    backend = "nccl" if (device_type == "cuda" and n == 1) else "gloo"
    return run_ranks(fn, n, backend=backend, device_type=device_type,
                     timeout_s=RANK_TIMEOUT_S)


def run(sizes, fused, device="cuda", seed=0) -> dict:
    """The tile-sharded render at each of sizes.scaling_ranks and config
    4's oracle on the frames and projectors of `fused`: the record the
    module note describes."""
    dev = common.resolve_device(device)
    cuda = dev.type == "cuda"
    out, timings = {}, {}
    ref = None
    parity, err, rows, share, wall, peaks = {}, {}, {}, {}, {}, {}
    oracle = None
    for n in sizes.scaling_ranks:
        ranks = _launch(functools.partial(
            scaling_rank, sizes.name, seed, dev.type, True,
            str(fused) if n == ORACLE_RANKS else None), n, dev.type)
        oracle = ranks[0].get("oracle", oracle)
        img = ranks[0]["image"]
        if ref is None:
            ref = img
        parity[n] = bool(np.allclose(img, ref, atol=PARITY_ATOL))
        err[n] = float(np.abs(img - ref).max())
        rows[n] = ranks[0]["rows"]
        # each rank's march: its rows x w4 x steps, over 1 rank's
        share[n] = (rows[n] * sizes.w4 * TILE_STEPS) / (
            sizes.h4 * sizes.w4 * TILE_STEPS)
        wall[n] = max(r["ms"] for r in ranks)
        if cuda:
            peaks[n] = [r["peak_gib"] for r in ranks]
        del img, ranks
    out.update(tile_parity=parity, tile_max_abs_vs_1_rank=err,
               tile_rows_per_rank=rows, tile_work_share_vs_1_rank=share,
               tile_shape=[sizes.h4, sizes.w4], tile_steps=TILE_STEPS)
    timings["tile_wall_ms_slowest_rank"] = wall
    if cuda:
        timings["tile_peak_gib_per_rank"] = peaks
    out["note"] = (
        "every world size shares one device, so wall time is no scaling "
        "evidence: the evidence is each world size's parity with 1 rank and "
        "each rank's share of the march, counted from shapes")
    if oracle is None:
        oracle = _launch(functools.partial(
            scaling_rank, sizes.name, seed, dev.type, False, str(fused)),
            ORACLE_RANKS, dev.type)[0]["oracle"]
    z = np.load(fused)
    fast = {"default": z["fast_default"], "0.1": z["fast_tol"]}
    for name, _ in FUSE_TOLS:
        out[f"psnr_{name}"] = common.psnr(fast[name], oracle[name])
    out["oracle"] = (f"render_fused_projectors over a {ORACLE_RANKS}-rank "
                     f"view mesh, {sizes.conv_steps} steps")
    if cuda:
        out.update(timings)
    else:
        out["cpu_smoke"] = timings
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=sorted(common.PRESETS),
                    default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: measurements) or cpu (tests)")
    ap.add_argument("--fused", required=True,
                    help="config 4's fused frames and projectors (the "
                    "configs runner's <out stem>_fused.npz)")
    args = ap.parse_args(argv)
    rec = run(common.PRESETS[args.preset], args.fused, args.device,
              args.seed)
    common.dump_line(rec)
    if not all(rec["tile_parity"].values()):
        return common.fail(f"bench_scaling_torch: FAILED: tile parity "
                           f"{rec['tile_parity']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
