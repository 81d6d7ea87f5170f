"""Baseline JPEG: native decode (C, ctypes) + numpy encode.

Copy of `rag_application_tpu/models/jpeg.py`.

The reference accepts any image format through torchvision/PIL
(app/core/models/imagebind/imagebind_handler.py:23-32) and rasterizes
pages to JPEG for its VLM (IndexerAPI/src/core/processors/utils.py:16-22).
Here JPEG joins PNG (models/image.py) as a natively-rasterized format:
``decode_jpeg`` drives native/jpeg.c (sequential DCT, Huffman, any
sampling incl. 4:2:0/4:2:2/4:4:4, restart intervals), so DCTDecode PDF
images, MJPEG-AVI frames and ``image_url`` data URLs all reach the
multimodal tower with no external decoder.

``encode_jpeg`` is the numpy encoder (Annex K tables, interleaved
baseline scan). It exists for round-trip fixtures and for serving paths
that must EMIT jpeg (VLM hooks take data URLs); quality work stays in
the decoder.

Failures raise ``JPEGError`` (an ``ImageError``) so callers' text-only
fallback applies unchanged.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .image import ImageError

__all__ = ["JPEGError", "decode_jpeg", "encode_jpeg", "probe_jpeg",
           "jpeg_to_input"]


class JPEGError(ImageError):
    """Malformed or unsupported JPEG."""


# same bound as PNG: the tower downsamples anyway; 24 MP covers any
# real page render, and bounds the C decoder's plane allocations
MAX_PIXELS = 24_000_000

_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_DIR, "jpeg.c")
_SO = os.path.join(_DIR, "libjpeg_rt.so")
_lib_handle: Optional[ctypes.CDLL] = None

_ERRORS = {
    -1: "malformed JPEG",
    -2: "unsupported JPEG (progressive/arithmetic/12-bit/CMYK)",
    -3: "truncated JPEG",
    -4: "dimension mismatch",
}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from ..native import build_lib

        try:
            so = build_lib(_SRC, _SO)
        except Exception as e:  # cc missing/failed -> degrade like any
            raise JPEGError(f"native jpeg decoder unavailable: {e}") from e
        lib = ctypes.CDLL(so)
        lib.jpeg_probe.restype = ctypes.c_int
        lib.jpeg_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int]
        _lib_handle = lib
    return _lib_handle


def probe_jpeg(data: bytes) -> Tuple[int, int, int]:
    """JPEG bytes -> (width, height, n_components) from the SOF header."""
    w = ctypes.c_int()
    h = ctypes.c_int()
    nc = ctypes.c_int()
    rc = _lib().jpeg_probe(data, len(data), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(nc))
    if rc != 0:
        raise JPEGError(_ERRORS.get(rc, f"jpeg error {rc}"))
    return w.value, h.value, nc.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) float32 RGB in [0, 1] (native decode)."""
    w, h, _nc = probe_jpeg(data)
    if w * h > MAX_PIXELS:
        raise JPEGError(f"JPEG too large ({w}x{h} > {MAX_PIXELS} px)")
    out = np.empty((h, w, 3), np.uint8)
    rc = _lib().jpeg_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), w, h)
    if rc != 0:
        raise JPEGError(_ERRORS.get(rc, f"jpeg error {rc}"))
    return out.astype(np.float32) / 255.0


def jpeg_to_input(data: bytes, size: int) -> np.ndarray:
    """JPEG bytes -> (size, size, 3) float32 tower input."""
    from .image import resize_raster

    return resize_raster(decode_jpeg(data), size)


# ---------------------------------------------------------------------
# Encoder (numpy): baseline interleaved scan, Annex K quant + Huffman
# tables (the tables ride in the DHT/DQT headers, so any conforming
# decoder — including decode_jpeg above and PIL in the cross-check
# tests — reads them from the file).

_QT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99], np.int32).reshape(8, 8)

_QT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99], np.int32).reshape(8, 8)

# Annex K.3 Huffman specs: (bits[1..16], values)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
            list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _zigzag() -> np.ndarray:
    zz = np.zeros(64, np.int32)
    x = y = 0
    for i in range(64):
        zz[i] = y * 8 + x
        if (x + y) % 2 == 0:
            if x == 7:
                y += 1
            elif y == 0:
                x += 1
            else:
                x += 1
                y -= 1
        else:
            if y == 7:
                x += 1
            elif x == 0:
                y += 1
            else:
                x -= 1
                y += 1
    return zz


_ZZ = _zigzag()


def _huff_codes(bits, vals):
    """{symbol: (code, length)} canonical codes from a bits/vals spec."""
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            b = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)          # byte stuffing
            self.n -= 8
        self.acc &= (1 << self.n) - 1


def _dct8x8_matrix() -> np.ndarray:
    m = np.zeros((8, 8), np.float64)
    for x in range(8):
        for u in range(8):
            cu = (1.0 / np.sqrt(2.0)) if u == 0 else 1.0
            m[x, u] = 0.5 * cu * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return m


_DCTM = _dct8x8_matrix()


def _fdct_blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) float centered samples -> (H/8, W/8, 8, 8) DCT coeffs."""
    h, w = plane.shape
    b = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    return np.einsum("xu,ijxy,yv->ijuv", _DCTM, b, _DCTM)


def _quality_scale(qt: np.ndarray, quality: int) -> np.ndarray:
    quality = min(100, max(1, quality))
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((qt * s + 50) // 100, 1, 255).astype(np.int32)


def _cat(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def encode_jpeg(img: np.ndarray, quality: int = 85,
                subsampling: str = "420",
                restart_interval: int = 0) -> bytes:
    """(H, W, 3) float [0,1] or uint8 RGB -> baseline JFIF bytes.

    subsampling: "444", "422" or "420" (chroma box-averaged).
    restart_interval > 0 emits DRI + RSTn every N MCUs (scanner output
    commonly does; exercises the decoder's resync path)."""
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img, np.float32) * 255.0 + 0.5,
                      0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise JPEGError("empty image")
    hs, vs = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[subsampling]

    r = img[..., 0].astype(np.float64)
    g = img[..., 1].astype(np.float64)
    b = img[..., 2].astype(np.float64)
    Y = 0.299 * r + 0.587 * g + 0.114 * b
    Cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    Cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def pad_to(plane, mh, mw):
        ph = (-plane.shape[0]) % mh
        pw = (-plane.shape[1]) % mw
        return np.pad(plane, ((0, ph), (0, pw)), mode="edge")

    # luma padded to the MCU grid; chroma subsampled then padded to 8
    Yp = pad_to(Y, 8 * vs, 8 * hs)
    if hs > 1 or vs > 1:
        cbs = pad_to(Cb, vs, hs)
        crs = pad_to(Cr, vs, hs)
        cbs = cbs.reshape(cbs.shape[0] // vs, vs,
                          cbs.shape[1] // hs, hs).mean(axis=(1, 3))
        crs = crs.reshape(crs.shape[0] // vs, vs,
                          crs.shape[1] // hs, hs).mean(axis=(1, 3))
    else:
        cbs, crs = Cb, Cr
    cbs = pad_to(cbs, 8, 8)
    crs = pad_to(crs, 8, 8)

    qly = _quality_scale(_QT_LUMA, quality)
    qlc = _quality_scale(_QT_CHROMA, quality)
    fy = _fdct_blocks(Yp - 128.0)
    fb = _fdct_blocks(cbs - 128.0)
    fr = _fdct_blocks(crs - 128.0)

    # ----- headers -----
    out = bytearray(b"\xff\xd8")                            # SOI
    out += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00" \
        + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0])

    def dqt(tq, qt):
        z = qt.reshape(-1)[_ZZ]
        return (b"\xff\xdb" + struct.pack(">H", 67) + bytes([tq])
                + bytes(int(v) for v in z))

    out += dqt(0, qly) + dqt(1, qlc)
    out += (b"\xff\xc0" + struct.pack(">H", 17) + bytes([8])
            + struct.pack(">HH", h, w) + bytes([3])
            + bytes([1, (hs << 4) | vs, 0])
            + bytes([2, 0x11, 1]) + bytes([3, 0x11, 1]))

    def dht(tc, th, spec):
        bits, vals = spec
        return (b"\xff\xc4" + struct.pack(">H", 19 + len(vals))
                + bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals))

    out += dht(0, 0, _DC_LUMA) + dht(1, 0, _AC_LUMA)
    out += dht(0, 1, _DC_CHROMA) + dht(1, 1, _AC_CHROMA)
    if restart_interval:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_interval)
    out += (b"\xff\xda" + struct.pack(">H", 12) + bytes([3])
            + bytes([1, 0x00, 2, 0x11, 3, 0x11]) + bytes([0, 63, 0]))

    # ----- interleaved entropy scan -----
    dcy = _huff_codes(*_DC_LUMA)
    acy = _huff_codes(*_AC_LUMA)
    dcc = _huff_codes(*_DC_CHROMA)
    acc = _huff_codes(*_AC_CHROMA)
    bw = _BitWriter()
    mcux = fy.shape[1] // hs
    mcuy = fy.shape[0] // vs
    preds = [0, 0, 0]

    def emit_block(f, qt, dc_codes, ac_codes, ci):
        q = np.round(f / qt).astype(np.int32)
        zz = q.reshape(-1)[_ZZ]
        dc = int(zz[0])
        diff = dc - preds[ci]
        preds[ci] = dc
        s = _cat(diff)
        code, ln = dc_codes[s]
        bw.put(code, ln)
        if s:
            bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
        nz = np.nonzero(zz[1:])[0]
        last = 0
        for idx in nz:
            k = int(idx) + 1
            run = k - last - 1
            last = k
            while run > 15:
                c2, l2 = ac_codes[0xF0]
                bw.put(c2, l2)
                run -= 16
            v = int(zz[k])
            s = _cat(v)
            c2, l2 = ac_codes[(run << 4) | s]
            bw.put(c2, l2)
            bw.put(v if v >= 0 else v + (1 << s) - 1, s)
        if last != 63:
            c2, l2 = ac_codes[0x00]
            bw.put(c2, l2)

    mcu_count = 0
    rst = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_count \
                    and mcu_count % restart_interval == 0:
                if bw.n:          # byte-align with 1-bits, then RSTn
                    bw.put((1 << (8 - bw.n)) - 1, 8 - bw.n)
                bw.out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                preds[0] = preds[1] = preds[2] = 0
            mcu_count += 1
            for bv in range(vs):
                for bh2 in range(hs):
                    emit_block(fy[my * vs + bv, mx * hs + bh2],
                               qly, dcy, acy, 0)
            emit_block(fb[my, mx], qlc, dcc, acc, 1)
            emit_block(fr[my, mx], qlc, dcc, acc, 2)
    if bw.n:
        pad = 8 - bw.n
        bw.put((1 << pad) - 1, pad)            # pad final byte with 1s
    out += bw.out
    out += b"\xff\xd9"                                      # EOI
    return bytes(out)
