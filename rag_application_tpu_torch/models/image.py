"""Image front-end: native PNG decode + raster prep for the multimodal
tower (stdlib zlib + numpy — the image-side analogue of models/audio.py).

Copy of `rag_application_tpu/models/image.py`.

The reference feeds raw image bytes to ImageBind's torchvision
preprocessing (app/core/models/imagebind/imagebind_handler.py:23-32)
and to the v2 interleaved-content embedding endpoint
(model_handler.py:131-169). Here PNG (the container the PDF extractor
itself emits, ingest/pdf.py::_make_png) decodes in this module; baseline
JPEG (DCTDecode PDF images, MJPEG frames, image_url data URLs) decodes
through the native C decoder in models/jpeg.py — ``decode_image`` /
``image_to_input`` dispatch on the magic bytes so both reach the
multimodal tower with no external decoder.

Supports non-interlaced 8-bit gray / gray+alpha / RGB / RGBA / palette
PNGs with all five row filters, plus 1/2/4-bit gray and palette depths
(what _make_png and common tooling produce).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

__all__ = ["ImageError", "PNGError", "decode_png", "decode_image",
           "resize_raster", "png_to_input", "image_to_input"]

_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"


class ImageError(ValueError):
    """Malformed or unsupported image of any natively-decoded format
    (callers catch this one type for the text-only fallback)."""


class PNGError(ImageError):
    """Malformed or unsupported PNG."""


# Client-supplied PNGs on /v1/embeddings: bound the decode work so a
# crafted header can't pin an executor thread (the tower downsamples to
# image_size anyway; 24 MP covers any real page render).
MAX_PIXELS = 24_000_000


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo per-row filters (PNG spec 9.2); returns (h, stride) bytes.

    None/Up are whole-row vector ops; Sub is a per-lane cumsum (addition
    mod 256 is linear, so int64 cumsum & 0xFF is exact); Average/Paeth
    keep only the serial a=cur[x-bpp] dependency, stepping x in units of
    bpp with the bpp lanes vectorized.
    """
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    npad = (-stride) % bpp
    for y in range(h):
        ftype = raw[pos]
        row = raw[pos + 1:pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        prev = out[y - 1].astype(np.int32) if y else np.zeros(stride, np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 2:                             # Up
            cur = (row + prev) & 0xFF
        elif ftype == 1:                             # Sub: cumsum per lane
            lanes = np.concatenate([row, np.zeros(npad, np.int32)])
            lanes = lanes.reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0, dtype=np.int64) & 0xFF)
            cur = cur.reshape(-1)[:stride].astype(np.int32)
        elif ftype in (3, 4):                        # Average/Paeth
            rowp = np.concatenate([row, np.zeros(npad, np.int32)])
            prevp = np.concatenate([prev, np.zeros(npad, np.int32)])
            rowl = rowp.reshape(-1, bpp)
            prevl = prevp.reshape(-1, bpp)
            curl = np.zeros_like(rowl)
            a = np.zeros(bpp, np.int32)
            c0 = np.zeros(bpp, np.int32)
            if ftype == 3:
                for k in range(rowl.shape[0]):
                    a = (rowl[k] + ((a + prevl[k]) >> 1)) & 0xFF
                    curl[k] = a
            else:
                for k in range(rowl.shape[0]):
                    b = prevl[k]
                    p = a + b - c0
                    pa = np.abs(p - a)
                    pb = np.abs(p - b)
                    pc = np.abs(p - c0)
                    pr = np.where((pa <= pb) & (pa <= pc), a,
                                  np.where(pb <= pc, b, c0))
                    a = (rowl[k] + pr) & 0xFF
                    curl[k] = a
                    c0 = b
            cur = curl.reshape(-1)[:stride]
        else:
            raise PNGError(f"bad filter type {ftype} on row {y}")
        out[y] = cur.astype(np.uint8)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) float32 RGB in [0, 1].

    Every malformed-input failure surfaces as PNGError so callers'
    text-only fallback applies (api/app.py catches PNGError only).
    """
    try:
        return _decode_png(data)
    except PNGError:
        raise
    except (struct.error, ValueError, IndexError, OverflowError) as e:
        raise PNGError(f"malformed PNG: {e}") from e


def _decode_png(data: bytes) -> np.ndarray:
    if data[:8] != _MAGIC:
        raise PNGError("not a PNG (bad signature)")
    pos = 8
    w = h = bit_depth = ctype = interlace = 0
    idat = bytearray()
    palette: Optional[np.ndarray] = None
    while pos + 8 <= len(data):
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length                           # incl. CRC
        if tag == b"IHDR":
            w, h, bit_depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if w == 0 or h == 0:
        raise PNGError("missing IHDR")
    if w * h > MAX_PIXELS:
        raise PNGError(f"PNG too large ({w}x{h} > {MAX_PIXELS} px)")
    if interlace:
        raise PNGError("interlaced PNG unsupported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise PNGError(f"bad color type {ctype}")
    if bit_depth not in (1, 2, 4, 8) or (bit_depth != 8 and ctype not in
                                         (0, 3)):
        raise PNGError(f"unsupported bit depth {bit_depth}/color {ctype}")
    try:
        raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    except zlib.error as e:
        raise PNGError(f"bad IDAT: {e}") from e
    stride = (w * channels * bit_depth + 7) // 8
    bpp = max(1, (channels * bit_depth + 7) // 8)
    if len(raw) < h * (stride + 1):
        raise PNGError("truncated pixel data")
    rows = _unfilter(raw, h, stride, bpp)
    if bit_depth < 8:
        bits = np.unpackbits(rows, axis=1)
        take = bits.reshape(h, -1, bit_depth)[:, :w]
        vals = np.zeros((h, w), np.uint8)
        for i in range(bit_depth):
            vals = (vals << 1) | take[:, :, i]
        if ctype == 0:                               # scale to 0..255
            vals = (vals.astype(np.uint16)
                    * (255 // ((1 << bit_depth) - 1))).astype(np.uint8)
        px = vals[..., None]
    else:
        px = rows[:, :w * channels].reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise PNGError("palette image without PLTE")
        rgb = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif channels == 1:
        rgb = np.repeat(px, 3, axis=2)
    elif channels == 2:                              # gray+alpha
        rgb = np.repeat(px[..., :1], 3, axis=2)
    elif channels == 4:
        rgb = px[..., :3]
    else:
        rgb = px
    return rgb.astype(np.float32) / 255.0


def resize_raster(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) -> (size, size, 3) by nearest-neighbor sampling (the
    tower's patch conv is robust to resampling detail)."""
    h, w = img.shape[:2]
    ys = np.minimum((np.arange(size) * h) // size, h - 1)
    xs = np.minimum((np.arange(size) * w) // size, w - 1)
    return img[ys][:, xs]


def png_to_input(data: bytes, size: int) -> np.ndarray:
    """PNG bytes -> (size, size, 3) float32 tower input."""
    return resize_raster(decode_png(data), size)


def decode_image(data: bytes) -> np.ndarray:
    """Any natively-decoded raster format -> (H, W, 3) float32 RGB.

    Dispatches on magic bytes: PNG here, baseline JPEG via the C
    decoder (models/jpeg.py). Everything else raises ImageError so the
    caller's text-only fallback applies (parity: the reference accepts
    any format via PIL, imagebind_handler.py:23-32)."""
    if data[:8] == _MAGIC:
        return decode_png(data)
    if data[:3] == _JPEG_MAGIC:
        from .jpeg import decode_jpeg

        return decode_jpeg(data)
    raise ImageError("unsupported image format (PNG and baseline JPEG "
                     "decode natively)")


def image_to_input(data: bytes, size: int) -> np.ndarray:
    """PNG/JPEG bytes -> (size, size, 3) float32 tower input."""
    return resize_raster(decode_image(data), size)
