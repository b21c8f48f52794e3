"""The port's LIF I/O against lif_tpu's (CPU).

The same bytes go through lif_tpu.io (PIL decode, its own native codec)
and lif_tpu_torch.io (zlib/numpy PNG decode, the port's copy of the C++
codec built into lif_tpu_torch/_build/). Gates: container fields and
normalized metadata equal; decoded arrays equal bit for bit; the PNG
decoder equal to PIL bit for bit for every 8-bit colour type and each of
the five row filters (hand-built rows, undone by the native library, by
the numpy fallback and by a plain-Python reference of the PNG
specification); image sizes equal to PIL's.
"""

import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from lif_tpu import native as jnative
from lif_tpu.io import container as jcontainer
from lif_tpu.io import decode as jdecode
from lif_tpu.io import schema as jschema
from lif_tpu_torch.io import container, decode, native, schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
_COLOUR_TYPE = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}


def _pil_bytes(arr, fmt="PNG", mode=None, **save):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format=fmt, **save)
    return buf.getvalue()


def _image(rng, h, w, ch):
    arr = (rng.random((h, w, ch)) * 255).astype(np.uint8)
    return arr[..., 0] if ch == 1 else arr


def _jpeg_bytes(rng, w=16, h=12):
    return _pil_bytes(_image(rng, h, w, 3), "JPEG")


def _png_bytes(rng, w=16, h=12, gray=True):
    return _pil_bytes(_image(rng, h, w, 1 if gray else 3))


def _fields(cont):
    return [(f.field_type, f.data) for f in cont.fields]


# --- the container ---------------------------------------------------------


@pytest.mark.parametrize("prefer_native", [True, False])
def test_container_round_trip(rng, prefer_native):
    """The port's writer and parser: the fields lif_tpu's parser reads from
    the same bytes, the JSON and blobs back, -1 the whole file
    (tests/test_io.py:32-41)."""
    jpeg = _jpeg_bytes(rng)
    depth = _png_bytes(rng)
    meta = {"views": [{"image": {"blob_id": -1}}], "baseline_mm": 45}
    data = container.write(jpeg, meta, {20: depth, 21: b""})
    assert data == jcontainer.write(jpeg, meta, {20: depth, 21: b""})
    cont = container.parse(data, prefer_native=prefer_native)
    assert _fields(cont) == _fields(jcontainer.parse(data))
    assert cont.json_meta() == meta
    assert cont.blob(20) == depth and cont.blob(21) == b""
    assert cont.blob(-1) == data
    with pytest.raises(container.LifParseError):
        cont.blob(99)
    with pytest.raises(ValueError, match="reserved"):
        container.write(jpeg, meta, {8: b"x"})


@pytest.mark.parametrize("prefer_native", [True, False])
def test_container_rejects_garbage(prefer_native):
    for bad in (b"not a lif file at all", b"\x00" * 100, b"\x1e\x1a",
                b"\x00" * 10 + b"\xff\xff\xff\xf0\x1e\x1a"):
        with pytest.raises(container.LifParseError):
            container.parse(bad, prefer_native=prefer_native)


def test_replace_keys_legacy_renames():
    """tests/test_io.py:51-61, and equal to lif_tpu's."""
    obj = {
        "albedo": {"blob_id": 3},
        "disparity": {"min_disparity": 0.1, "max_disparity": 0.9},
        "nested": [{"inv_z_dist": {"inv_z_dist_min": 2.0,
                                   "inv_z_dist_max": 0.1}}],
    }
    out = schema.replace_keys(obj)
    assert out == jschema.replace_keys(obj)
    assert out["inv_z_map"] == {"min": 0.1, "max": 0.9}
    # the deliberate inversion: inv_z_dist_min -> max, _max -> min
    assert out["nested"][0]["inv_z_map"] == {"max": 2.0, "min": 0.1}


def _legacy_meta(kind):
    """The metadata of tests/test_io.py's modern, legacy camera_data and
    legacy LDI outpainting views."""
    if kind == "modern":
        return {"views": [{
            "image": {"blob_id": -1},
            "inv_z_map": {"blob_id": 20, "min": 0.5, "max": 0.01},
            "width_px": 16, "height_px": 12, "focal_px": 12.48,
            "position": [0, 0, 0], "rotation": [0, 0, 0],
        }]}
    if kind == "camera_data":
        return {"views": [{
            "image": {"blob_id": -1},
            "inv_z_map": {"blob_id": 20, "min": -0.39, "max": -0.0078},
            "camera_data": {
                "focal_ratio_to_width": 0.78, "position": [0.1, 0.2, 0.3],
                "rotation": [0, 0, 0], "frustum_skew": [0.01, -0.02],
            },
        }]}
    return {"views": [{
        "image": {"blob_id": -1},
        "inv_z_map": {"blob_id": 20, "min": 0.5, "max": 0.01},
        "width_px": 16, "height_px": 12, "focal_px": 0.78 * 16,
        "camera_data": {"focal_ratio_to_width": 0.78},
        "layered_depth_image_data": {
            "outpainting_added_width_px": 4,
            "outpainting_added_height_px": 4,
            "layers_top_to_bottom": [{
                "image": {"blob_id": 21},
                "inv_z_map": {"blob_id": 22, "min": -0.39, "max": -0.0078},
            }],
        },
    }]}


@pytest.mark.parametrize("kind", ["modern", "camera_data", "ldi_outpainting"])
@pytest.mark.parametrize("outer", ["JPEG", "PNG"])
def test_process_views_equal_lif_tpu(rng, kind, outer):
    """load_meta on the same file: the normalized views (blob bytes,
    legacy dims from the image, focal and invZ rescales, outpainted layer
    dims) equal lif_tpu's (tests/test_io.py:64-155), with the outer image
    a JPEG (its size from the SOFn marker) or a PNG (from IHDR)."""
    outer_img = (_jpeg_bytes(rng, 16, 12) if outer == "JPEG"
                 else _png_bytes(rng, 16, 12, gray=False))
    blobs = {20: _png_bytes(rng, 16, 12)}
    if kind == "ldi_outpainting":
        blobs[21] = _jpeg_bytes(rng, 20, 16)
        blobs[22] = _png_bytes(rng, 20, 16)
    data = container.write(outer_img, _legacy_meta(kind), blobs)
    got = schema.load_meta(container.parse(data))
    assert got == jschema.load_meta(jcontainer.parse(data))
    view = got["views"][0]
    assert view["image"]["bytes"] == data
    if kind == "camera_data":
        assert view["width_px"] == 16 and view["height_px"] == 12
        assert view["frustum_skew"] == [0.01, -0.02]
        assert abs(view["inv_z_map"]["min"] - (-0.39 / -0.78)) < 1e-12
    if kind == "ldi_outpainting":
        layer = view["layers_top_to_bottom"][0]
        assert (layer["width_px"], layer["height_px"]) == (20, 16)
        assert "camera_data" not in layer


# --- the native codec ------------------------------------------------------


@pytest.fixture(scope="module")
def lib():
    if native.load_library() is None:
        pytest.skip(f"native codec unavailable: {native.build_error()}")
    return native.load_library()


def _sample(rng):
    jpeg = b"\xff\xd8\xff" + rng.bytes(500) + b"\xff\xd9"
    meta = {"views": [{"image": {"blob_id": -1}}], "baseline_mm": 45}
    blobs = {20: rng.bytes(300), 21: rng.bytes(5), 55: b""}
    return container.write(jpeg, meta, blobs), blobs


def test_native_builds_into_the_build_dir(lib):
    """The port's codec is its own copy, built into lif_tpu_torch/_build/
    under a hash of source and flags, never beside its source."""
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.join(ROOT, "lif_tpu_torch",
                                                 "_build")
    assert os.path.basename(path).startswith("liblif_container-")
    assert not any(n.endswith(".so") for n in
                   os.listdir(os.path.join(ROOT, "lif_tpu_torch", "csrc")))


def test_native_parse_matches_python(rng, lib):
    """tests/test_native.py:24-33 on the port's codec, and its offsets
    equal lif_tpu's native codec's."""
    data, blobs = _sample(rng)
    py = container.parse(data, prefer_native=False)
    nat = container.parse(data, prefer_native=True)
    assert _fields(py) == _fields(nat)
    assert nat.json_meta() == py.json_meta()
    assert nat.blob(20) == blobs[20] and nat.blob(55) == b""
    if jnative.load_library() is not None:
        assert native.parse_fields(data) == jnative.parse_fields(data)


def test_native_rejects_garbage(lib):
    with pytest.raises(ValueError):
        native.parse_fields(b"garbage data that is not a lif")
    with pytest.raises(container.LifParseError):
        container.parse(b"\x00" * 64, prefer_native=True)


def test_native_write_matches_python(rng, lib):
    jpeg = b"\xff\xd8" + rng.bytes(100) + b"\xff\xd9"
    fields = [(8, b'{"views": []}'), (20, rng.bytes(64))]
    nat_bytes = native.write_container(jpeg, fields)
    cont = container.parse(nat_bytes, prefer_native=False)
    assert _fields(cont) == fields
    assert nat_bytes == container.write(jpeg, {"views": []},
                                        {20: fields[1][1]})


def test_native_round_trip_large(rng, lib):
    """A ~5 MB container parses identically in both codecs."""
    jpeg = rng.bytes(2_000_000) + b"\xff\xd9"
    blobs = {i: rng.bytes(300_000) for i in range(20, 30)}
    data = container.write(jpeg, {"views": []}, blobs)
    assert _fields(container.parse(data, prefer_native=False)) == _fields(
        container.parse(data, prefer_native=True))


def test_native_write_rejects_u32_overflow(lib):
    """Field sizes and the region offset are u32 on disk; the writer
    refuses payloads that would silently truncate (>4 GiB)."""
    import ctypes

    types = (ctypes.c_uint32 * 1)(8)
    payloads = (ctypes.c_char_p * 1)(b"tiny")
    sizes = (ctypes.c_uint64 * 1)(1 << 32)  # guard fires before any memcpy
    out = ctypes.create_string_buffer(64)
    out_size = ctypes.c_uint64(0)
    rc = lib.lif_write(b"\xff\xd8\xff\xd9", 4, types, payloads, sizes, 1,
                       out, 64, ctypes.byref(out_size))
    assert rc == -7  # LIF_ERR_FIELD_TOO_LARGE


# --- PNG without PIL -------------------------------------------------------


def _paeth_reference(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _predict(ft, x, prior, i, bpp):
    """The PNG specification's predictor of byte i (ISO/IEC 15948, 9.2),
    from the unfiltered bytes x of this row and `prior` of the one
    above."""
    a = x[i - bpp] if i >= bpp else 0
    b = prior[i]
    c = prior[i - bpp] if i >= bpp else 0
    return (0, a, b, (a + b) // 2, _paeth_reference(a, b, c))[ft]


def _filter_reference(img, bpp, types):
    """Filter uint8 rows (H, stride) with one type per row: the raw
    zlib payload of a PNG, byte by byte."""
    out = bytearray()
    prior = [0] * img.shape[1]
    for row, ft in zip(img.tolist(), types):
        out.append(ft)
        out.extend((row[i] - _predict(ft, row, prior, i, bpp)) & 0xFF
                   for i in range(len(row)))
        prior = row
    return bytes(out)


def _unfilter_reference(raw, rows, stride, bpp):
    """Undo the row filters byte by byte, in plain Python."""
    out, prior, pos = [], [0] * stride, 0
    for _ in range(rows):
        ft, x = raw[pos], [0] * stride
        for i in range(stride):
            x[i] = (raw[pos + 1 + i] + _predict(ft, x, prior, i, bpp)) & 0xFF
        out.append(x)
        prior, pos = x, pos + 1 + stride
    return np.asarray(out, np.uint8)


def _png_from_raw(w, h, ctype, raw, depth=8, interlace=0):
    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    return (decode.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("save", [{}, {"optimize": True},
                                  {"compress_level": 1}])
def test_png_decode_equals_pil(rng, mode, save):
    """8-bit PNGs written by PIL (its adaptive filters), each colour type:
    decode_image equals PIL's array, image_dimensions PIL's size."""
    arr = _image(rng, 37, 53, _MODES[mode])
    data = _pil_bytes(arr, mode=mode, **save)
    with Image.open(io.BytesIO(data)) as im:
        want, size = np.asarray(im), im.size
    got = decode.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert decode.image_dimensions(data) == size


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_png_row_filters(rng, mode, ftype):
    """Hand-built rows for each of the five filter types (and a random
    type per row): the native unfilter, the numpy fallback and the
    plain-Python reference all give the image back, and decode_image
    equals PIL on the file."""
    h, w, ch = 11, 19, _MODES[mode]
    arr = _image(rng, h, w, ch)
    rows = arr.reshape(h, w * ch)
    types = (rng.integers(0, 5, h).tolist() if ftype == "mixed"
             else [ftype] * h)
    raw = _filter_reference(rows, ch, types)
    assert np.array_equal(_unfilter_reference(raw, h, w * ch, ch), rows)
    assert np.array_equal(decode._unfilter_numpy(raw, h, w * ch, ch), rows)
    nat = native.png_unfilter(raw, h, w * ch, ch)
    if nat is not None:
        assert np.array_equal(nat, rows)
    data = _png_from_raw(w, h, _COLOUR_TYPE[mode], raw)
    with Image.open(io.BytesIO(data)) as im:
        assert np.array_equal(decode.decode_image(data), np.asarray(im))


@pytest.mark.parametrize("case,match", [
    ("16-bit", "16-bit greyscale"), ("palette", "palette"),
    ("interlaced", "interlaced"), ("bad_filter", "row filter type"),
    ("bad_crc", "CRC"), ("truncated", "truncated"),
])
def test_png_unsupported_raises_naming_it(rng, case, match):
    """A PNG this decoder does not take raises ValueError naming what it
    found: 16-bit, palette, interlaced, or a corrupt file."""
    w, h = 6, 4
    raw = _filter_reference(_image(rng, h, w, 3).reshape(h, -1), 3, [0] * h)
    if case == "16-bit":
        data = _png_from_raw(w, h, 0, bytes(h * (1 + 2 * w)), depth=16)
    elif case == "palette":
        data = _pil_bytes(np.asarray(Image.fromarray(
            _image(rng, h, w, 3)).convert("P")), mode="P")
    elif case == "interlaced":
        data = _png_from_raw(w, h, 2, raw, interlace=1)
    elif case == "bad_filter":
        data = _png_from_raw(w, h, 2, b"\x07" + raw[1:])
    elif case == "bad_crc":
        data = bytearray(_png_from_raw(w, h, 2, raw))
        data[-20] ^= 0xFF  # inside the IDAT body
        data = bytes(data)
    else:
        data = _png_from_raw(w, h, 2, raw[: len(raw) // 2])
    with pytest.raises(ValueError, match=match):
        decode.decode_image(data)
    if case == "bad_filter":
        with pytest.raises(ValueError, match="filter type 7"):
            decode._unfilter_numpy(b"\x07" + raw[1:], h, 3 * w, 3)


def test_decoded_arrays_equal_lif_tpu(rng):
    """decode_rgb (linear and not), decode_depth and decode_mask equal
    lif_tpu's bit for bit on the same PNG and JPEG bytes."""
    blobs = [_pil_bytes(_image(rng, 12, 17, ch), mode=m)
             for m, ch in _MODES.items()] + [_jpeg_bytes(rng, 17, 12)]
    for data in blobs:
        for linear in (True, False):
            a, b = decode.decode_rgb(data, linear), jdecode.decode_rgb(
                data, linear)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
        assert np.array_equal(decode.decode_depth(data),
                              jdecode.decode_depth(data))
        assert np.array_equal(decode.decode_mask(data, (12, 17)),
                              jdecode.decode_mask(data, (12, 17)))
    assert np.array_equal(decode.decode_mask(None, (2, 3)),
                          jdecode.decode_mask(None, (2, 3)))


@pytest.mark.parametrize("save", [{}, {"progressive": True},
                                  {"quality": 40, "subsampling": 0}])
def test_jpeg_decode_and_dimensions(rng, save):
    """JPEG decodes through PIL where it can be imported: equal to
    lif_tpu's decode_rgb bit for bit; image_dimensions reads the SOFn
    marker without PIL and equals PIL's size (baseline and progressive)."""
    data = _pil_bytes(_image(rng, 23, 41, 3), "JPEG", **save)
    assert np.array_equal(decode.decode_rgb(data), jdecode.decode_rgb(data))
    with Image.open(io.BytesIO(data)) as im:
        assert decode.image_dimensions(data) == im.size
    with pytest.raises(ValueError, match="SOFn"):
        decode.image_dimensions(b"\xff\xd8\xff\xd9")


def test_encode_png_round_trip(rng):
    """encode_png (zlib, filter 0): PIL reads back the quantized,
    top-down image, for greyscale, RGB and RGBA; decode_rgb of an sRGB
    encode returns the linear input to quantization (tests/test_io.py's
    round trip)."""
    for shape in ((8, 10), (8, 10, 3), (8, 10, 4), (8, 10, 2)):
        x = rng.random(shape).astype(np.float32)
        data = decode.encode_png(x)
        with Image.open(io.BytesIO(data)) as im:
            assert np.array_equal(
                np.asarray(im), (np.clip(x, 0, 1) * 255).astype(np.uint8)[::-1])
    rgb = rng.random((8, 10, 3)).astype(np.float32) * 0.8
    srgb = np.where(rgb <= 0.0031308, rgb * 12.92,
                    1.055 * np.power(rgb, 1 / 2.4) - 0.055)
    back = decode.decode_rgb(decode.encode_png(srgb))
    np.testing.assert_allclose(back, rgb, atol=2e-2)
    assert np.array_equal(decode.to_display(rgb), rgb[::-1])


_BLOCKED = r"""
import sys
sys.modules["PIL"] = None
sys.modules["jax"] = None
import numpy as np
import lif_tpu_torch as lt
from lif_tpu_torch.io import container, decode

h, w = 16, 24
rng = np.random.default_rng(0)
png = decode.encode_png(rng.random((h, w, 3)))
depth = decode.encode_png(rng.random((h, w)))
view = {"image": {"blob_id": 20}, "inv_z_map": {"blob_id": 21, "min": 2.0,
        "max": 0.1}, "width_px": w, "height_px": h, "focal_px": 0.78 * w}
lif = container.write(png, {"views": [view]}, {20: png, 21: depth})
res = lt.load_lif_file(lif, device="cpu")
cam = lt.Camera.create(w, h, focal_px=0.78 * w, position=[0.05, 0.0, 0.0])
img = lt.render(res.projectors[0], cam, mode="fast")
assert tuple(img.shape) == (h, w, 4) and bool(img.isfinite().all())
jpeg = b"\xff\xd8\xff\xe0" + bytes(64)
lif = container.write(jpeg, {"views": [dict(view, image={"blob_id": -1})]},
                      {21: depth})
try:
    lt.load_lif_file(lif, device="cpu")
except ImportError as e:
    assert "PIL" in str(e), e
    print("ok")
"""


def test_png_lif_without_pil_or_jax():
    """With PIL and JAX blocked, the port imports, loads a PNG-payload LIF
    on the CPU and renders it with render(mode='fast'); a JPEG payload
    raises ImportError naming PIL."""
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
