"""Image decode and texture preparation.

The counterpart of lif_tpu.io.decode (the python analog of the
reference's texture pipeline, src/utils/textureUtils.ts and
HoloProjector.ts:215-258):

  * RGB images are sRGB; sampling in WebGL decodes them to linear light,
    so the arrays we feed the kernels are linear float32.
  * Inverse-depth maps are linear-colourspace; their (first-channel) value
    in [0,1] is the normalized disparity.
  * Masks contribute their RED channel as the alpha of the packed
    depth+mask texture (textureUtils.ts:69-81).
  * All arrays are flipped to GL orientation (row 0 = v=0 = image bottom)
    so the kernels' uv math matches the shaders exactly; I/O boundaries
    flip back.

lif_tpu decodes everything through PIL, which a GPU host need not have.
Here 8-bit non-interlaced PNG (greyscale, greyscale+alpha, RGB, RGBA)
decodes with the standard library's zlib and numpy; the five row filters
are undone by the native library (io.native, csrc/lif_container.cpp) or,
without a compiler, by _unfilter_numpy. Any other PNG raises ValueError
naming what it found. JPEG (and any other format) goes to PIL where PIL
can be imported, and raises ImportError naming PIL where it cannot. The
decoded arrays equal lif_tpu's bit for bit on the same bytes.
"""

from __future__ import annotations

import io as _io
import struct
import zlib

import numpy as np

__all__ = [
    "decode_image",
    "image_dimensions",
    "decode_rgb",
    "decode_depth",
    "decode_mask",
    "encode_jpeg",
    "encode_png",
    "to_display",
]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the 8-bit types decoded here
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_PNG_COLOUR = {0: "greyscale", 2: "RGB", 3: "palette", 4: "greyscale+alpha",
               6: "RGBA"}
# JPEG start-of-frame markers (every SOFn but DHT 0xC4, JPG 0xC8, DAC 0xCC)
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def _srgb_to_linear_np(x: np.ndarray) -> np.ndarray:
    """Numpy sRGB EOTF, in lif_tpu's float32 arithmetic order."""
    return np.where(
        x <= 0.04045, x / 12.92, np.power((x + 0.055) / 1.055, 2.4)
    ).astype(np.float32)


def _pil_image(what: str):
    """PIL's Image module, or ImportError naming PIL and what needed it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{what} needs PIL (Pillow), which cannot be imported here; "
            "only 8-bit PNG decodes without it"
        ) from e
    return Image


def _image_kind(data: bytes) -> str:
    if data[:8] == PNG_SIGNATURE:
        return "PNG"
    if data[:2] == b"\xff\xd8":
        return "JPEG"
    return "non-PNG image"


# ---------------------------------------------------------------------------
# PNG without PIL
# ---------------------------------------------------------------------------


def _png_chunks(data: bytes):
    """(type, body) of each chunk through IEND; the CRC of the critical
    chunks (IHDR, PLTE, IDAT, IEND) is checked."""
    pos, n = len(PNG_SIGNATURE), len(data)
    while pos + 12 <= n:
        length, ctype = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if end + 4 > n:
            raise ValueError(f"PNG chunk {ctype!r} is truncated")
        body = data[pos + 8 : end]
        if ctype[:1].isupper():
            (crc,) = struct.unpack_from(">I", data, end)
            if zlib.crc32(ctype + body) != crc:
                raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG ends before its IEND chunk")


def _png_header(data: bytes):
    """(width, height, bit depth, colour type, interlace) from IHDR."""
    if data[:8] != PNG_SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError("not a PNG (no signature and IHDR)")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack_from(
        ">IIBBBBB", data, 16)
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt}: "
                         "only method 0 exists")
    return w, h, depth, ctype, interlace


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_numpy(raw: bytes, rows: int, stride: int, bpp: int):
    """Undo the PNG row filters in numpy, for hosts without the native
    library: None, Sub and Up vectorised along the row; Average and Paeth
    run serially along it (each byte needs the unfiltered byte bpp to
    its left). Returns (rows, stride) uint8."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < rows * (stride + 1):
        raise ValueError("PNG image data is truncated")
    buf = buf[: rows * (stride + 1)].reshape(rows, stride + 1)
    out = np.empty((rows, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(rows):
        ft, f = int(buf[r, 0]), buf[r, 1:]
        if ft == 0:
            out[r] = f
        elif ft == 1:
            out[r] = np.cumsum(f.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ft == 2:
            out[r] = f + prior
        elif ft in (3, 4):
            fl, pl, x = f.tolist(), prior.tolist(), [0] * stride
            for i in range(stride):
                a = x[i - bpp] if i >= bpp else 0
                if ft == 3:
                    pred = (a + pl[i]) >> 1
                else:
                    pred = _paeth(a, pl[i], pl[i - bpp] if i >= bpp else 0)
                x[i] = (fl[i] + pred) & 0xFF
            out[r] = x
        else:
            raise ValueError(f"PNG row filter type {ft} outside 0..4")
        prior = out[r]
    return out


def _decode_png(data: bytes) -> np.ndarray:
    w, h, depth, ctype, interlace = _png_header(data)
    kind = _PNG_COLOUR.get(ctype, f"colour type {ctype}")
    if depth != 8 or ctype not in _PNG_CHANNELS:
        raise ValueError(
            f"{depth}-bit {kind} PNG: only 8-bit greyscale, greyscale+alpha, "
            "RGB and RGBA PNGs decode without PIL")
    if interlace:
        raise ValueError(f"interlaced (Adam7) {kind} PNG: only "
                         "non-interlaced PNGs decode without PIL")
    idat = b"".join(body for t, body in _png_chunks(data) if t == b"IDAT")
    raw = zlib.decompress(idat)
    ch = _PNG_CHANNELS[ctype]
    from . import native

    rows = native.png_unfilter(raw, h, w * ch, ch)
    if rows is None:
        rows = _unfilter_numpy(raw, h, w * ch, ch)
    return rows.reshape(h, w) if ch == 1 else rows.reshape(h, w, ch)


def _png_bytes(img: np.ndarray, compress_level: int = 6) -> bytes:
    """uint8 (H, W[, C]) top-down -> an 8-bit PNG (row filter 0)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)], 1)

    def chunk(ctype_, body):
        return (struct.pack(">I", len(body)) + ctype_ + body
                + struct.pack(">I", zlib.crc32(ctype_ + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
            + chunk(b"IEND", b""))


def _jpeg_dimensions(data: bytes) -> tuple[int, int]:
    """(width, height) from the first SOFn marker of a JPEG."""
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError("JPEG: a marker was expected")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue  # markers without a segment
        if marker in (0xD9, 0xDA) or pos + 2 > n:
            break  # image data or the end before any frame header
        (seg,) = struct.unpack_from(">H", data, pos)
        if marker in _JPEG_SOF:
            if pos + 7 > n:
                break
            h, w = struct.unpack_from(">HH", data, pos + 3)
            return w, h
        pos += seg
    raise ValueError("JPEG has no SOFn frame header")


# ---------------------------------------------------------------------------
# lif_tpu's decode surface
# ---------------------------------------------------------------------------


def decode_image(data: bytes) -> np.ndarray:
    """Decode image bytes to a uint8 numpy array (H, W[, C]), top-down:
    8-bit PNG here, anything else through PIL."""
    data = bytes(data)
    if data[:8] == PNG_SIGNATURE:
        return _decode_png(data)
    Image = _pil_image(f"decoding a {_image_kind(data)}")
    with Image.open(_io.BytesIO(data)) as im:
        return np.asarray(im)


def image_dimensions(data: bytes) -> tuple[int, int]:
    """(width, height) without full decode: the PNG IHDR chunk or the JPEG
    SOFn marker (PIL for other formats). reference: LifLoader.ts:425-441."""
    data = bytes(data)
    if data[:8] == PNG_SIGNATURE:
        return tuple(_png_header(data)[:2])
    if data[:2] == b"\xff\xd8":
        return _jpeg_dimensions(data)
    Image = _pil_image(f"reading the size of a {_image_kind(data)}")
    with Image.open(_io.BytesIO(data)) as im:
        return im.width, im.height


def decode_rgb(data: bytes, linear: bool = True) -> np.ndarray:
    """RGB bytes -> (H, W, 3) float32, GL-oriented; linear light by default
    (the WebGL sRGB-texture decode, HoloProjector.ts:223)."""
    arr = decode_image(data)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = arr[..., :3].astype(np.float32) / 255.0
    arr = arr[::-1].copy()  # GL orientation
    if linear:
        arr = _srgb_to_linear_np(arr)
    return arr


def decode_depth(data: bytes) -> np.ndarray:
    """Inverse-depth bytes -> (H, W) float32 in [0,1], GL-oriented.

    WebGL reads the texture's first channel; depth maps are loaded in
    linear colourspace, so the byte value maps straight to [0,1]
    (HoloProjector.ts:240-258)."""
    arr = decode_image(data)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr.astype(np.float32) / 255.0)[::-1].copy()


def decode_mask(data: bytes | None, shape: tuple[int, int]) -> np.ndarray:
    """Mask bytes -> (H, W) float32 alpha from the RED channel, GL-oriented;
    all-ones when absent. reference: textureUtils.ts:69-81."""
    if data is None:
        return np.ones(shape, dtype=np.float32)
    arr = decode_image(data)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return (arr.astype(np.float32) / 255.0)[::-1].copy()


def encode_jpeg(rgb_linear: np.ndarray, quality: int = 92) -> bytes:
    """(H, W, 3) linear float GL-oriented -> sRGB JPEG bytes (top-down).
    Needs PIL."""
    Image = _pil_image("encoding a JPEG")
    x = np.clip(np.asarray(rgb_linear), 0.0, 1.0)
    srgb = np.where(
        x <= 0.0031308, x * 12.92, 1.055 * np.power(x, 1 / 2.4) - 0.055
    )
    img = (np.clip(srgb, 0, 1) * 255).astype(np.uint8)[::-1]
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def encode_png(gray_or_rgb: np.ndarray) -> bytes:
    """(H, W[, C]) float [0,1] GL-oriented -> PNG bytes (top-down), with
    C in 1..4 (greyscale, greyscale+alpha, RGB, RGBA)."""
    img = (np.clip(gray_or_rgb, 0, 1) * 255).astype(np.uint8)[::-1]
    return _png_bytes(img)


def to_display(image_gl: np.ndarray) -> np.ndarray:
    """Flip a GL-oriented render back to top-down display order."""
    return np.asarray(image_gl)[::-1]
