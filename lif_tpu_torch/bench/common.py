"""What the runners share: their sizes, the device, timing, launch counts,
fidelity bars and the JSON they print.

Numbers from a CPU run (``--device cpu``, the tests' device) are kept
apart from the card's: split_record files them under ``cpu_smoke``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass(frozen=True)
class BenchSizes:
    """Every axis of the benches, one preset each (PRESETS)."""

    name: str
    w: int  # the scene's width and height, px
    h: int
    conv_steps: int  # steps of the converged exact march (the oracle)
    reps: int  # timed passes of the headline and the configs' sections
    batch: int  # headline poses, and config 0's one-call batch
    third: int  # poses of each composite family
    n_seq: int  # config 0's sequential views
    batch_stream: int  # config 0's streaming batch
    bb_batch: int  # config 0b+'s two billboard batches
    bb_small: int
    orbit_frames: int  # configs 1 and 1b
    n_pairs: int  # config 2
    n_ldi: int  # config 3
    w4: int  # config 4's fused projectors and the tile-sharded view, px
    h4: int
    scaling_ranks: tuple  # world sizes of the tile-sharded render


# full: the JAX benches' axes (bench.py, bench_configs.py, bench_scaling.py);
# smoke: their BENCH_SMOKE=1 axes (bench_configs.py:40-53), the scaling at
# 1 and 2 ranks; tiny: the CPU tests' (256x160 keeps the orbit on the
# target tier)
FULL = BenchSizes("full", 1280, 800, 640, 5, 432, 144, 20, 40, 96, 48, 120,
                  48, 192, 3840, 2160, (1, 2, 4, 8))
SMOKE = BenchSizes("smoke", 640, 400, 640, 1, 16, 5, 4, 8, 8, 4, 12, 4, 24,
                   1280, 800, (1, 2))
TINY = BenchSizes("tiny", 256, 160, 640, 1, 4, 2, 2, 2, 2, 1, 4, 2, 4, 256,
                  160, (1, 2, 4))
PRESETS = {s.name: s for s in (FULL, SMOKE, TINY)}
PSNR_TOL_DB = 1.0  # a PSNR may sit this far under lif_tpu's on the same input


def resolve_device(name: str) -> torch.device:
    """The run's device. 'cuda' (the default of every runner) needs a card:
    a measurement never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the benches measure on a CUDA card, and torch finds no CUDA "
            "device on this host (no card); --device cpu runs them on the "
            "CPU for the tests, without device metrics")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {name!r}: the benches run on cuda or cpu")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def source_digest(root) -> str:
    """sha256 over the port's sources (lif_tpu_torch's .py, .cu and .cpp
    files and the three root runners, by relative path): names the code
    that made a record where no git checkout says which commit it was."""
    root = Path(root)
    files = sorted(p for p in (root / "lif_tpu_torch").rglob("*")
                   if p.suffix in (".py", ".cu", ".cpp", ".h")
                   and "_build" not in p.parts)
    files += [root / name for name in ("bench_torch.py",
                                       "bench_configs_torch.py",
                                       "bench_scaling_torch.py")]
    h = hashlib.sha256()
    for p in files:
        h.update(p.relative_to(root).as_posix().encode() + b"\0")
        h.update(p.read_bytes() + b"\0")
    return h.hexdigest()


def provenance(dev: torch.device, root) -> dict:
    """Which code and card made a record: the git commit (None outside a
    git checkout) and the sources' digest (source_digest)."""
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=root, capture_output=True, text=True,
                             timeout=10).stdout.strip()
    except OSError:
        rev = ""
    out = {"commit": rev or None, "source_sha256": source_digest(root),
           "device": dev.type, "card": card_line(dev)}
    if dev.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
        out["device_count"] = torch.cuda.device_count()
    return out


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def seconds(fn, dev: torch.device, reps: int) -> list:
    """Host seconds of `reps` calls of fn, each ending in a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def median(xs) -> float:
    return float(statistics.median(xs))


def marginal_rate(t_big, n_big, t_small, n_small) -> float | None:
    """Items/s between two batch sizes of one call: the slope cancels the
    call's fixed cost. None where the larger call did not take longer (a
    spread wider than the difference)."""
    if t_big <= t_small:
        return None
    return float((n_big - n_small) / (t_big - t_small))


def psnr(a, b) -> float:
    """PSNR (dB) of the RGB of a against b, both in [0, 1]."""
    mse = float(((a[..., :3] - b[..., :3]) ** 2).mean())
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def split_record(dev: torch.device, fidelity: dict, timings: dict) -> dict:
    """A section's record: its fidelity, counts and routes, and its
    timings, which a CPU run files under 'cpu_smoke'."""
    if dev.type == "cuda":
        return {**fidelity, **timings}
    return {**fidelity, "cpu_smoke": timings}


def launch_counter():
    """counts(reset=False): zero every kernel's launch count (reset) or
    read them, {kernel: launches}. A wrapper counts only the launches of
    its CUDA kernel: on the CPU every count stays 0."""
    from ..ops.cuda import splat_march as kbb
    from ..ops.cuda import sweep_march as kmarch
    from ..ops.cuda import sweep_scaled as kscaled
    from ..ops.cuda import sweep_target as ktarget

    wrappers = {"lateral_march": kmarch.sweep_lateral,
                "target_march": ktarget.sweep_target,
                "scaled_march": kscaled.sweep_scaled,
                "billboard_march": kbb.sweep_billboard}

    def counts(reset=False):
        if reset:
            for fn in wrappers.values():
                fn.launches = 0
        return {name: fn.launches for name, fn in wrappers.items()}

    return counts


@contextlib.contextmanager
def unobserved(step: str):
    """The runners' default `observe`: a step (a counted call, by name)
    runs as it is. A caller's observe(step) context manager wraps each
    step, to zero and read the launch counts around it and hold its
    kernel calls (chip_smoke.py)."""
    yield


def counted(dev: torch.device, fn, *args, **kwargs):
    """(fn's result, {kernel: launches it made}): the launch counts read
    before and after the call."""
    counts = launch_counter()
    before = counts()
    out = fn(*args, **kwargs)
    sync(dev)
    return out, {k: v - before[k] for k, v in counts().items()
                 if v != before[k]}


def bar_misses(where: str, got: dict, lif_tpu: dict | None) -> list:
    """Each PSNR of `got` more than PSNR_TOL_DB under lif_tpu's value on
    the same input, and each route that differs from lif_tpu's, as text;
    no bars (lif_tpu None) for a preset without reference values."""
    if lif_tpu is None:
        return []
    misses = []
    for key, want in lif_tpu.items():
        have = got.get(key)
        if isinstance(want, tuple):
            if have != want:
                misses.append(f"{where} {key}: routed {have}, lif_tpu {want}")
        elif have is None or have < want - PSNR_TOL_DB:
            misses.append(f"{where} {key}: {have} dB, lif_tpu {want} dB")
    return misses


def tiers_tuple(tiers):
    """render_fast_batch's or render_stereo_fast_batch's tiers, as nested
    tuples (JSON gives lists)."""
    if isinstance(tiers, (list, tuple)):
        return tuple(tiers_tuple(t) for t in tiers)
    return tiers


def dump_line(obj: dict):
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(msg, file=sys.stderr, flush=True)
    return 1
