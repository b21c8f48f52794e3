"""The native (C++) LIF codec and PNG unfilter, through ctypes.

The counterpart of lif_tpu.native. The library is built on demand from
lif_tpu_torch/csrc/lif_container.cpp with g++ into
``lif_tpu_torch/_build/liblif_container-<hash>.so``, the hash covering the
source and the flags (as ops/cuda/build.py builds the kernels): nothing
is written beside the source. Where no compiler is available the callers
use their pure-Python paths (io.container.parse, io.decode's numpy
unfilter); build_error() says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["MAX_FIELDS", "build_error", "load_library", "parse_fields",
           "png_unfilter", "write_container"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "lif_container.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


class LifFieldStruct(ctypes.Structure):
    _fields_ = [
        ("field_type", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32),
        ("offset", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
    ]


def _build() -> tuple[Path | None, str | None]:
    """Compile the shared library if needed: (path, None) or (None,
    error)."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_FLAGS).encode()
    ).hexdigest()[:16]
    so = _BUILD_DIR / f"liblif_container-{digest}.so"
    if so.exists():
        return so, None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: a concurrent or
    # interrupted build never leaves a half-written library behind
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, so)
        return so, None
    except FileNotFoundError:
        return None, "g++ not available"
    except subprocess.CalledProcessError as e:
        return None, f"compile failed: {e.stderr[:500]}"
    except subprocess.TimeoutExpired:
        return None, "compile timed out"
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library():
    """The ctypes library handle, or None when native support is
    unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        so, err = _build()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(str(so))
        lib.lif_parse.restype = ctypes.c_int
        lib.lif_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(LifFieldStruct),
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.lif_validate.restype = ctypes.c_int
        lib.lif_validate.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.lif_write_size.restype = ctypes.c_uint64
        lib.lif_write_size.argtypes = [
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32,
        ]
        lib.lif_write.restype = ctypes.c_int
        lib.lif_write.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint32,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lif_png_unfilter.restype = ctypes.c_int
        lib.lif_png_unfilter.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def build_error() -> str | None:
    return _build_error


MAX_FIELDS = 4096


def parse_fields(data: bytes) -> list[tuple[int, int, int]] | None:
    """Parse with the native codec: [(field_type, offset, size), ...].
    Returns None when native support is unavailable; raises ValueError on
    malformed input (same classification as the Python parser)."""
    lib = load_library()
    if lib is None:
        return None
    fields = (LifFieldStruct * MAX_FIELDS)()
    count = ctypes.c_uint32(0)
    rc = lib.lif_parse(data, len(data), fields, MAX_FIELDS, ctypes.byref(count))
    if rc != 0:
        raise ValueError(f"native LIF parse failed (code {rc})")
    return [
        (fields[i].field_type, fields[i].offset, fields[i].size)
        for i in range(count.value)
    ]


def write_container(jpeg: bytes, fields: list[tuple[int, bytes]]) -> bytes | None:
    """Author a LIF container natively. Returns None when unavailable."""
    lib = load_library()
    if lib is None:
        return None
    n = len(fields)
    types = (ctypes.c_uint32 * n)(*[t for t, _ in fields])
    payloads = (ctypes.c_char_p * n)(*[p for _, p in fields])
    sizes = (ctypes.c_uint64 * n)(*[len(p) for _, p in fields])
    need = lib.lif_write_size(len(jpeg), sizes, n)
    out = ctypes.create_string_buffer(need)
    out_size = ctypes.c_uint64(0)
    rc = lib.lif_write(
        jpeg, len(jpeg), types, payloads, sizes, n, out, need,
        ctypes.byref(out_size),
    )
    if rc != 0:
        raise ValueError(f"native LIF write failed (code {rc})")
    return out.raw[: out_size.value]


def png_unfilter(raw: bytes, rows: int, stride: int, bpp: int):
    """Undo the PNG row filters natively: `raw` holds `rows` rows of one
    filter-type byte and `stride` filtered bytes; returns the unfiltered
    rows as a (rows, stride) uint8 array, or None when native support is
    unavailable. Raises ValueError on a short buffer or an unknown filter
    type."""
    import numpy as np

    lib = load_library()
    if lib is None:
        return None
    out = np.empty((rows, stride), np.uint8)
    rc = lib.lif_png_unfilter(raw, len(raw), rows, stride, bpp,
                              out.ctypes.data)
    if rc != 0:
        raise ValueError(
            "PNG image data is truncated" if rc == -8
            else f"PNG row filter type outside 0..4 (code {rc})")
    return out
