"""Build and load the package's hand-written CUDA kernels.

Each kernel source ``lif_tpu_torch/csrc/<name>.cu`` exposes a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper (sm_90a)
into ``lif_tpu_torch/_build/lib<name>-<hash>.so`` and loaded with ctypes;
the hash covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.
Nothing is prebuilt: a machine without nvcc cannot launch a kernel, and
the loader raises there.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "load_library"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# --fmad=false: no multiply-add contraction anywhere in the kernels, so
# their float32 arithmetic rounds step by step exactly as the plain
# PyTorch twins do (a contracted lerp can flip a first-crossing test at
# a tie)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (once per source hash) and load it."""
    src = CSRC_DIR / f"{name}.cu"
    # the shared device headers a source may include rebuild it too
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: a concurrent or
        # interrupted build never leaves a half-written library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src}:\n{res.stdout}{res.stderr}"
                )
            (BUILD_DIR / f"lib{name}-{digest}.log").write_text(
                res.stdout + res.stderr
            )
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(lib))
