"""Native JBIG2 decoding for PDF-embedded streams (ITU-T T.88).

Copy of `rag_application_tpu/ingest/jbig2.py`.

Covers the subset scanner pipelines actually emit for bilevel pages:
generic regions — MQ-arithmetic coded with templates 0-3 + TPGDON, or
MMR (T.6, reusing ingest/ccitt.py) — plus symbol dictionaries (T.88
§6.5) and text regions (§6.4) in their arithmetic-coded form (the
jbig2enc default; Annex-A integer decoding + shared-stream generic
bitmaps run in C). Regions composite onto the page bitmap with the
segment's external combination operator; the embedded segment-header
format (§7.2) and JBIG2Globals are handled. Also covered:
halftone regions + pattern dictionaries (§6.6/§6.7, gray-code
bitplanes on the shared MQ stream), page refinement regions (§6.3,
types 40/42/43), refinement/aggregate symbols (§6.5.8.2,
REFAGGNINST=1), SBREFINE text instances (§6.4.11), and the
HUFFMAN-coded symbol dictionary / text region forms (SDHUFF/SBHUFF=1,
Annex B standard tables + type-53 custom code tables + the
runcode-coded symbol-ID table — older scanner firmware). Only TPGRON,
Huffman+refinement combinations, and multi-instance aggregates raise
:class:`JBIG2Error`, so the pipeline falls back to the
``pdf_rasterizer`` hook exactly as before for those.

The per-pixel MQ loop lives in C (native/jbig2.c, ctypes) — a 300-dpi
page is ~8M pixels x 16 context loads. The encoder here (MQ encoder +
generic-region coder, pure Python) exists for roundtrip tests: no
real-world JBIG2 fixture ships with the reference, so tests validate
decoder/encoder agreement on the exact bit protocol plus the segment
plumbing.

Parity anchor: the reference rasterizes scanned PDFs via
pdf2image/unoserver (IndexerAPI/src/core/processors/utils.py:16-22);
this module recovers the embedded bitmap itself with no renderer.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["JBIG2Error", "decode_embedded", "decode_generic",
           "decode_jbig2_params", "encode_embedded", "encode_generic",
           "encode_halftone", "encode_refined_page", "encode_symbol_text",
           "encode_symbol_text_huffman"]


class JBIG2Error(ValueError):
    """Malformed stream or a JBIG2 feature outside the generic subset."""


# Region/page dimensions come from untrusted segment payloads; bound the
# allocation so a crafted header raises JBIG2Error (-> pdf_rasterizer
# fallback) instead of a multi-GB MemoryError. 60 MP covers A0 @ 300dpi.
MAX_PIXELS = 60_000_000


# ------------------------------------------------------- native decoder

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "..", "native", "jbig2.c")
_SO = os.path.join(_DIR, "..", "native", "libjbig2.so")
_lib_handle: Optional[ctypes.CDLL] = None

_NOMINAL_AT = {
    0: [(3, -1), (-3, -1), (2, -2), (-2, -2)],
    1: [(3, -1)],
    2: [(2, -1)],
    3: [(2, -1)],
}

# coding templates (T.88 figures 4, 8-10); the context is these plus
# the AT pixels, in raster (y, x) order, MSB first — must match
# native/jbig2.c::build_template and the encoder below
_CODING_TEMPLATE = {
    0: [(-1, -2), (0, -2), (1, -2), (-2, -1), (-1, -1), (0, -1), (1, -1),
        (2, -1), (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
    1: [(-1, -2), (0, -2), (1, -2), (2, -2), (-2, -1), (-1, -1), (0, -1),
        (1, -1), (2, -1), (-3, 0), (-2, 0), (-1, 0)],
    2: [(-1, -2), (0, -2), (1, -2), (-2, -1), (-1, -1), (0, -1), (1, -1),
        (-2, 0), (-1, 0)],
    3: [(-3, -1), (-2, -1), (-1, -1), (0, -1), (1, -1), (-4, 0), (-3, 0),
        (-2, 0), (-1, 0)],
}

_SLTP_CTX = {0: 0x9B25, 1: 0x0795, 2: 0x00E5, 3: 0x0195}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from ..native import build_lib
        so = build_lib(os.path.abspath(_SRC), os.path.abspath(_SO))
        lib = ctypes.CDLL(so)
        lib.jbig2_generic_decode.restype = ctypes.c_int
        lib.jbig2_generic_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_byte),
            ctypes.c_char_p]
        lib.jbig2_mq_new.restype = ctypes.c_void_p
        lib.jbig2_mq_new.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.jbig2_mq_free.argtypes = [ctypes.c_void_p]
        lib.jbig2_int_decode.restype = ctypes.c_int
        lib.jbig2_int_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32)]
        lib.jbig2_iaid_decode.restype = ctypes.c_int
        lib.jbig2_iaid_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.jbig2_generic_into.restype = ctypes.c_int
        lib.jbig2_generic_into.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_byte)]
        lib.jbig2_refine_into.restype = ctypes.c_int
        lib.jbig2_refine_into.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_byte), ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib_handle = lib
    return _lib_handle


def decode_generic(data: bytes, w: int, h: int, *, template: int = 0,
                   tpgdon: bool = False,
                   at: Optional[List[Tuple[int, int]]] = None,
                   mmr: bool = False) -> np.ndarray:
    """Decode one generic region to an (h, w) uint8 bitmap (1 = black)."""
    if w <= 0 or h <= 0:
        raise JBIG2Error(f"bad region size {w}x{h}")
    if w * h > MAX_PIXELS:
        raise JBIG2Error(f"region too large ({w}x{h} > {MAX_PIXELS} px)")
    if mmr:
        from .ccitt import CCITTError, decode_ccitt
        try:
            packed, n = decode_ccitt(data, w, rows=h, k=-1)
        except CCITTError as e:
            raise JBIG2Error(f"MMR region: {e}") from e
        row_bytes = (w + 7) // 8
        if n < h:
            packed = packed + b"\x00" * ((h - n) * row_bytes)
        rows = np.frombuffer(packed[:h * row_bytes], np.uint8)
        return np.unpackbits(rows.reshape(h, row_bytes), axis=1)[:, :w]
    if template not in (0, 1, 2, 3):
        raise JBIG2Error(f"bad GB template {template}")
    pairs = at or _NOMINAL_AT[template]
    at_c = (ctypes.c_byte * 8)()
    for i, (ax, ay) in enumerate(pairs):
        at_c[2 * i], at_c[2 * i + 1] = ax, ay
    out = ctypes.create_string_buffer(w * h)
    rc = _lib().jbig2_generic_decode(
        bytes(data), len(data), w, h, template, 1 if tpgdon else 0,
        at_c, out)
    if rc != 0:
        raise JBIG2Error(f"generic region decode failed (rc={rc})")
    return np.frombuffer(out.raw, np.uint8).reshape(h, w).copy()


# ------------------------------------- arithmetic decoder (shared MQ)

class _ArithDecoder:
    """One MQ stream + the Annex-A integer/ID decoders over it, used by
    symbol dictionaries (T.88 6.5) and text regions (6.4). Per-bit and
    per-pixel loops run in C; this class owns the context banks."""

    def __init__(self, data: bytes):
        self._data = data                 # keep alive for the C pointer
        self._h = _lib().jbig2_mq_new(data, len(data))
        if not self._h:
            raise JBIG2Error("MQ decoder allocation failed")
        self._int_cx: dict = {}
        self._gb_cx = ctypes.create_string_buffer(1 << 16)
        self._gr_cx: Optional[ctypes.Array] = None
        self._iaid_cx: Optional[ctypes.Array] = None

    def close(self) -> None:
        if self._h:
            _lib().jbig2_mq_free(self._h)
            self._h = None

    def __enter__(self) -> "_ArithDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def decode_int(self, name: str) -> Optional[int]:
        """One Annex A.2 integer from the ``name`` class; None = OOB."""
        cx = self._int_cx.get(name)
        if cx is None:
            cx = self._int_cx[name] = ctypes.create_string_buffer(512)
        out = ctypes.c_int32()
        rc = _lib().jbig2_int_decode(self._h, cx, ctypes.byref(out))
        return int(out.value) if rc == 1 else None

    def decode_iaid(self, symcodelen: int) -> int:
        if self._iaid_cx is None:
            self._iaid_cx = ctypes.create_string_buffer(
                1 << (symcodelen + 1))
        return int(_lib().jbig2_iaid_decode(self._h, self._iaid_cx,
                                            symcodelen))

    def decode_generic(self, w: int, h: int, *, template: int,
                       at: List[Tuple[int, int]]) -> np.ndarray:
        """One bitmap on the shared stream with the shared GB bank."""
        if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
            raise JBIG2Error(f"bad shared-region size {w}x{h}")
        at_c = (ctypes.c_byte * 8)()
        for i, (ax, ay) in enumerate(at):
            at_c[2 * i], at_c[2 * i + 1] = ax, ay
        out = ctypes.create_string_buffer(w * h)
        rc = _lib().jbig2_generic_into(self._h, self._gb_cx, out, w, h,
                                       template, 0, at_c)
        if rc != 0:
            raise JBIG2Error(f"shared generic decode failed (rc={rc})")
        return np.frombuffer(out.raw, np.uint8).reshape(h, w).copy()

    def decode_refine(self, w: int, h: int, ref: np.ndarray, *,
                      template: int,
                      at: List[Tuple[int, int]],
                      dx: int = 0, dy: int = 0) -> np.ndarray:
        """One refinement bitmap (6.3.5) against ``ref`` on the shared
        stream with the shared GR stats bank (13-bit contexts)."""
        if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
            raise JBIG2Error(f"bad refinement size {w}x{h}")
        if self._gr_cx is None:
            self._gr_cx = ctypes.create_string_buffer(1 << 13)
        ref = np.ascontiguousarray(np.asarray(ref, np.uint8))
        at_c = (ctypes.c_byte * 4)()
        for i, (ax, ay) in enumerate(at[:2]):
            at_c[2 * i], at_c[2 * i + 1] = ax, ay
        out = ctypes.create_string_buffer(w * h)
        rc = _lib().jbig2_refine_into(
            self._h, self._gr_cx, out, w, h, template, at_c,
            ref.tobytes(), ref.shape[1], ref.shape[0], dx, dy)
        if rc != 0:
            raise JBIG2Error(f"refinement decode failed (rc={rc})")
        return np.frombuffer(out.raw, np.uint8).reshape(h, w).copy()


# --------------------------------------------------- symbol dictionary

_MAX_SYMBOLS = 100_000


def _decode_symbol_dict(payload: bytes, input_syms: List[np.ndarray],
                        tables: Optional[List["_HuffTable"]] = None,
                        ) -> List[np.ndarray]:
    """Symbol dictionary segment (type 0) -> exported symbol bitmaps
    (T.88 6.5). REFAGG=0 (the jbig2enc default) and single-instance
    refinement/aggregate symbols (6.5.8.2) decode in the arithmetic
    form; SDHUFF=1 takes the Annex-B Huffman path (standard or
    referred custom tables, collective bitmaps uncompressed or MMR).
    Huffman+refagg and multi-instance aggregates raise (-> rasterizer
    hook)."""
    if len(payload) < 2:
        raise JBIG2Error("short symbol dictionary")
    flags = struct.unpack(">H", payload[:2])[0]
    sdhuff = flags & 1
    refagg = (flags >> 1) & 1
    ctx_used = (flags >> 8) & 1
    ctx_retained = (flags >> 9) & 1
    template = (flags >> 10) & 3
    rtemplate = (flags >> 12) & 1
    if ctx_used or ctx_retained:
        raise JBIG2Error("cross-segment context retention (unsupported)")
    if sdhuff:
        if refagg:
            raise JBIG2Error(
                "Huffman refinement/aggregate symbols (unsupported)")
        return _decode_symbol_dict_huffman(payload, input_syms,
                                           list(tables or []), flags)
    pos = 2
    nat = 4 if template == 0 else 1
    at = []
    for i in range(nat):
        ax, ay = struct.unpack(">bb", payload[pos:pos + 2])
        at.append((ax, ay))
        pos += 2
    rat = [(-1, -1), (-1, -1)]
    if refagg and rtemplate == 0:                     # SDRAT (7.4.3.1.3)
        rat = [struct.unpack(">bb", payload[pos:pos + 2]),
               struct.unpack(">bb", payload[pos + 2:pos + 4])]
        pos += 4
    num_ex, num_new = struct.unpack(">II", payload[pos:pos + 8])
    pos += 8
    if num_new > _MAX_SYMBOLS or num_ex > _MAX_SYMBOLS + len(input_syms):
        raise JBIG2Error(f"symbol counts out of range ({num_new}/{num_ex})")
    # SBSYMCODELEN for refinement-aggregate symbol references (6.5.8.2.3)
    n_total = len(input_syms) + num_new
    symcodelen = max(1, (max(n_total - 1, 0)).bit_length())

    pool: List[np.ndarray] = list(input_syms)   # inputs + decoded news
    new_syms: List[np.ndarray] = []
    budget = MAX_PIXELS
    with _ArithDecoder(payload[pos:]) as dec:
        hc_height = 0
        while len(new_syms) < num_new:
            dh = dec.decode_int("IADH")
            if dh is None:
                raise JBIG2Error("OOB height-class delta")
            hc_height += dh
            if not 0 < hc_height <= 1 << 20:
                raise JBIG2Error(f"bad height class {hc_height}")
            sym_width = 0
            while True:
                dw = dec.decode_int("IADW")
                if dw is None:
                    break                    # end of height class
                sym_width += dw
                if not 0 < sym_width <= 1 << 20:
                    raise JBIG2Error(f"bad symbol width {sym_width}")
                if len(new_syms) >= num_new:
                    raise JBIG2Error("too many symbols in dictionary")
                budget -= sym_width * hc_height
                if budget < 0:
                    raise JBIG2Error("symbol dictionary exceeds pixel budget")
                if not refagg:
                    sym = dec.decode_generic(
                        sym_width, hc_height, template=template, at=at)
                else:
                    # refinement/aggregate symbol (6.5.8.2)
                    ninst = dec.decode_int("IAAI")
                    if ninst is None or ninst < 1:
                        raise JBIG2Error("bad aggregate instance count")
                    if ninst != 1:
                        raise JBIG2Error(
                            "multi-instance aggregate symbols (unsupported)")
                    sid = dec.decode_iaid(symcodelen)
                    rdx = dec.decode_int("IARDX")
                    rdy = dec.decode_int("IARDY")
                    if rdx is None or rdy is None:
                        raise JBIG2Error("OOB refinement offset")
                    if not 0 <= sid < len(pool):
                        raise JBIG2Error(
                            f"refagg symbol id {sid} out of range")
                    sym = dec.decode_refine(
                        sym_width, hc_height, pool[sid],
                        template=rtemplate, at=rat, dx=rdx, dy=rdy)
                new_syms.append(sym)
                pool.append(sym)
        # export flags: alternating skip/export run lengths, skip first
        # (6.5.10: CUREXFLAG starts 0)
        all_syms = list(input_syms) + new_syms
        exported: List[np.ndarray] = []
        i, exflag = 0, 0
        while i < len(all_syms):
            run = dec.decode_int("IAEX")
            if run is None or run < 0:
                raise JBIG2Error("bad export run length")
            if exflag:
                exported.extend(all_syms[i:i + run])
            i += run
            exflag ^= 1
    if len(exported) != num_ex:
        raise JBIG2Error(
            f"exported {len(exported)} symbols, header said {num_ex}")
    return exported


def _decode_symbol_dict_huffman(payload: bytes,
                                input_syms: List[np.ndarray],
                                tables: List["_HuffTable"],
                                flags: int) -> List[np.ndarray]:
    """SDHUFF=1 symbol dictionary (T.88 6.5 with Annex B tables):
    per-height-class DH/DW deltas are Huffman-coded; the class's
    bitmaps arrive as ONE collective bitmap (6.5.9), byte-aligned,
    either uncompressed (BMSIZE=0) or MMR-coded, then split by width.
    Export runs use Table B.1 (6.5.10)."""
    customs = list(tables)
    dh_t = _select_table((flags >> 2) & 3, {0: 4, 1: 5}, 3, customs,
                         "SDHUFFDH")
    dw_t = _select_table((flags >> 4) & 3, {0: 2, 1: 3}, 3, customs,
                         "SDHUFFDW")
    bm_t = _select_table((flags >> 6) & 1, {0: 1}, 1, customs,
                         "SDHUFFBMSIZE")
    if (flags >> 7) & 1:                          # SDHUFFAGGINST custom
        _select_table(1, {0: 1}, 1, customs, "SDHUFFAGGINST")  # consume
    ex_t = _std_table(1)                          # 6.5.10: EXRUNLENGTH

    pos = 2                                       # no AT pixels (SDHUFF)
    if len(payload) < pos + 8:
        raise JBIG2Error("short symbol dictionary")
    num_ex, num_new = struct.unpack(">II", payload[pos:pos + 8])
    pos += 8
    if num_new > _MAX_SYMBOLS or num_ex > _MAX_SYMBOLS + len(input_syms):
        raise JBIG2Error(f"symbol counts out of range ({num_new}/{num_ex})")

    br = _BitReader(payload[pos:])
    new_syms: List[np.ndarray] = []
    budget = MAX_PIXELS
    hc_height = 0
    while len(new_syms) < num_new:
        dh = dh_t.decode(br)
        if dh is None:
            raise JBIG2Error("OOB height-class delta")
        hc_height += dh
        if not 0 < hc_height <= 1 << 20:
            raise JBIG2Error(f"bad height class {hc_height}")
        widths: List[int] = []
        sym_width = 0
        tot_width = 0
        while True:
            dw = dw_t.decode(br)
            if dw is None:
                break                             # end of height class
            sym_width += dw
            if not 0 < sym_width <= 1 << 20:
                raise JBIG2Error(f"bad symbol width {sym_width}")
            if len(new_syms) + len(widths) >= num_new:
                raise JBIG2Error("too many symbols in dictionary")
            widths.append(sym_width)
            tot_width += sym_width
            budget -= sym_width * hc_height
            if budget < 0:
                raise JBIG2Error("symbol dictionary exceeds pixel budget")
        if not widths:
            continue
        bmsize = bm_t.decode(br)
        if bmsize is None or bmsize < 0:
            raise JBIG2Error("bad collective bitmap size")
        br.byte_align()
        start = pos + br.bytepos
        stride = (tot_width + 7) // 8
        if bmsize == 0:                           # uncompressed (6.5.9)
            need = stride * hc_height
            raw = payload[start:start + need]
            if len(raw) < need:
                raise JBIG2Error("truncated collective bitmap")
            coll = np.unpackbits(
                np.frombuffer(raw, np.uint8).reshape(hc_height, stride),
                axis=1)[:, :tot_width]
            br.skip_bytes(need)
        else:
            coll = decode_generic(payload[start:start + bmsize],
                                  tot_width, hc_height, mmr=True)
            br.skip_bytes(bmsize)
        off = 0
        for w in widths:
            new_syms.append(np.ascontiguousarray(coll[:, off:off + w]))
            off += w

    # export flags (6.5.10): alternating skip/export runs, Table B.1
    all_syms = list(input_syms) + new_syms
    exported: List[np.ndarray] = []
    i, exflag = 0, 0
    while i < len(all_syms):
        run = ex_t.decode(br)
        if run is None or run < 0:
            raise JBIG2Error("bad export run length")
        if exflag:
            exported.extend(all_syms[i:i + run])
        i += run
        exflag ^= 1
    if len(exported) != num_ex:
        raise JBIG2Error(
            f"exported {len(exported)} symbols, header said {num_ex}")
    return exported


# ------------------------------------------- pattern dict + halftones

def _decode_pattern_dict(payload: bytes) -> List[np.ndarray]:
    """Pattern dictionary segment (type 16) -> list of (HDPH, HDPW)
    pattern bitmaps (T.88 6.7). The patterns arrive as ONE collective
    bitmap of width (GRAYMAX+1)*HDPW decoded with AT1 = (-HDPW, 0) —
    the left-neighbour-pattern prediction — then split."""
    if len(payload) < 7:
        raise JBIG2Error("short pattern dictionary")
    flags = payload[0]
    if flags & 1:
        raise JBIG2Error("MMR pattern dictionary (unsupported)")
    template = (flags >> 1) & 3
    hdpw, hdph = payload[1], payload[2]
    graymax = struct.unpack(">I", payload[3:7])[0]
    if hdpw == 0 or hdph == 0:
        raise JBIG2Error(f"bad pattern size {hdpw}x{hdph}")
    if hdpw > 127:
        raise JBIG2Error("pattern wider than the AT1 reach (127)")
    if (graymax + 1) * hdpw * hdph > MAX_PIXELS:
        raise JBIG2Error(f"pattern dictionary too large (graymax "
                         f"{graymax}, {hdpw}x{hdph})")
    at = [(-hdpw, 0), (-3, -1), (2, -2), (-2, -2)]
    if template != 0:
        at = at[:1]
    with _ArithDecoder(payload[7:]) as dec:
        coll = dec.decode_generic((graymax + 1) * hdpw, hdph,
                                  template=template, at=at)
    return [coll[:, i * hdpw:(i + 1) * hdpw].copy()
            for i in range(graymax + 1)]


def _decode_halftone_region(payload: bytes, patterns: List[np.ndarray]
                            ) -> Tuple[int, int, int, np.ndarray]:
    """Halftone region segment (types 20/22/23) -> (x, y, ext_op,
    bitmap) (T.88 6.6; arithmetic, HENABLESKIP=0). The grayscale image
    is Annex C.5 gray-coded bitplanes, MSB first, all on one MQ stream
    with shared GB stats; each grid cell (m, n) stamps
    ``patterns[gray[m, n]]`` at the 8.8 fixed-point grid position."""
    w, h, x, y, ext_op = _region_info(payload)
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise JBIG2Error(f"bad halftone region size {w}x{h}")
    if not patterns:
        raise JBIG2Error("halftone region with no pattern dictionary")
    if len({p.shape for p in patterns}) != 1:
        # decode_embedded merges patterns across referred dicts (and all
        # dicts when refs miss); mixed sizes would broadcast-error at the
        # stamp below — keep the raise-to-rasterizer contract instead
        raise JBIG2Error("halftone patterns differ in shape across dicts")
    if len(payload) < 38:
        raise JBIG2Error("short halftone region")
    flags = payload[17]
    if flags & 1:
        raise JBIG2Error("MMR halftone region (unsupported)")
    template = (flags >> 1) & 3
    if (flags >> 3) & 1:
        raise JBIG2Error("HENABLESKIP halftone region (unsupported)")
    comb_op = (flags >> 4) & 7
    def_pixel = (flags >> 7) & 1
    hgw, hgh = struct.unpack(">II", payload[18:26])
    hgx, hgy = struct.unpack(">ii", payload[26:34])
    hrx, hry = struct.unpack(">HH", payload[34:38])
    if hgw == 0 or hgh == 0 or hgw * hgh > MAX_PIXELS:
        raise JBIG2Error(f"bad halftone grid {hgw}x{hgh}")
    bits = max(1, (len(patterns) - 1).bit_length())   # HBPP (6.6.5.1)

    at = [(3 if template <= 1 else 2, -1), (-3, -1), (2, -2), (-2, -2)]
    if template != 0:
        at = at[:1]
    gray = np.zeros((hgh, hgw), np.int32)
    with _ArithDecoder(payload[38:]) as dec:
        prev: Optional[np.ndarray] = None
        for j in range(bits - 1, -1, -1):             # MSB plane first
            plane = dec.decode_generic(hgw, hgh, template=template,
                                       at=at)
            if prev is not None:
                plane = plane ^ prev                  # gray -> binary
            gray |= plane.astype(np.int32) << j
            prev = plane
    gray = np.minimum(gray, len(patterns) - 1)

    region = np.full((h, w), def_pixel, np.uint8)
    ph, pw = patterns[0].shape
    for m in range(hgh):
        row = gray[m]
        for n in range(hgw):
            px = (hgx + m * hry + n * hrx) >> 8       # 6.6.5.2 grid walk
            py = (hgy + m * hrx - n * hry) >> 8
            pat = patterns[int(row[n])]
            x0, y0 = max(px, 0), max(py, 0)
            x1, y1 = min(px + pw, w), min(py + ph, h)
            if x0 >= x1 or y0 >= y1:
                continue
            view = region[y0:y1, x0:x1]
            part = pat[y0 - py:y1 - py, x0 - px:x1 - px]
            if comb_op == 0:
                view |= part
            elif comb_op == 1:
                view &= part
            elif comb_op == 2:
                view ^= part
            elif comb_op == 3:
                view[...] = 1 - (view ^ part)
            else:
                view[...] = part
    return x, y, ext_op, region


# --------------------------------------------------------- text region

def _decode_text_region(payload: bytes, syms: List[np.ndarray],
                        tables: Optional[List["_HuffTable"]] = None,
                        ) -> Tuple[int, int, int, np.ndarray]:
    """Text region segment (types 4-6) -> (x, y, ext_op, bitmap)
    (T.88 6.4). Arithmetic instances refine per 6.4.11 (SBREFINE);
    SBHUFF=1 takes the Annex-B path (standard/custom tables + the
    runcode-coded symbol-ID table, §7.4.4.1.4) — Huffman with
    refinement raises (-> rasterizer hook)."""
    w, h, x, y, ext_op = _region_info(payload)
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise JBIG2Error(f"bad text region size {w}x{h}")
    pos = 17
    if len(payload) < pos + 6:
        raise JBIG2Error("short text region")
    flags = struct.unpack(">H", payload[pos:pos + 2])[0]
    pos += 2
    sbhuff = flags & 1
    sbrefine = (flags >> 1) & 1
    log_strips = (flags >> 2) & 3
    ref_corner = (flags >> 4) & 3           # 0 BL, 1 TL, 2 BR, 3 TR
    transposed = (flags >> 6) & 1
    comb_op = (flags >> 7) & 3
    def_pixel = (flags >> 9) & 1
    ds_offset = (flags >> 10) & 0x1F
    if ds_offset > 15:
        ds_offset -= 32                     # signed 5-bit
    sbrtemplate = (flags >> 15) & 1
    if sbhuff:
        if sbrefine:
            raise JBIG2Error(
                "Huffman text region with refinement (unsupported)")
        return _decode_text_region_huffman(
            payload, syms, list(tables or []), pos,
            (w, h, x, y, ext_op), log_strips, ref_corner, transposed,
            comb_op, def_pixel, ds_offset)
    rat = [(-1, -1), (-1, -1)]
    if sbrefine and sbrtemplate == 0:       # SBRAT (7.4.4.1.2)
        rat = [struct.unpack(">bb", payload[pos:pos + 2]),
               struct.unpack(">bb", payload[pos + 2:pos + 4])]
        pos += 4
    num_instances = struct.unpack(">I", payload[pos:pos + 4])[0]
    pos += 4
    if num_instances > 10 * _MAX_SYMBOLS:
        raise JBIG2Error(f"instance count out of range ({num_instances})")
    if not syms:
        raise JBIG2Error("text region with no symbols")
    strips = 1 << log_strips
    symcodelen = max(1, (len(syms) - 1).bit_length())

    region = np.full((h, w), def_pixel, np.uint8)

    def draw(sym: np.ndarray, s: int, t: int) -> None:
        """Blit with the strip coordinate mapped per REFCORNER /
        TRANSPOSED (6.4.5 step 3c viii)."""
        sh, sw = sym.shape
        # corner encoding: 0 BL, 1 TL, 2 BR, 3 TR -> LEFT={0,1}, TOP={1,3}
        if transposed:
            # S runs vertically, T horizontally
            ry = s if ref_corner in (1, 3) else s - sh + 1
            rx = t if ref_corner in (0, 1) else t - sw + 1
        else:
            rx = s if ref_corner in (0, 1) else s - sw + 1
            ry = t if ref_corner in (1, 3) else t - sh + 1
        x0, y0 = max(rx, 0), max(ry, 0)
        x1, y1 = min(rx + sw, w), min(ry + sh, h)
        if x0 >= x1 or y0 >= y1:
            return
        view = region[y0:y1, x0:x1]
        part = sym[y0 - ry:y1 - ry, x0 - rx:x1 - rx]
        if comb_op == 0:
            view |= part
        elif comb_op == 1:
            view &= part
        elif comb_op == 2:
            view ^= part
        else:
            view[...] = 1 - (view ^ part)

    with _ArithDecoder(payload[pos:]) as dec:
        dt0 = dec.decode_int("IADT")
        if dt0 is None:
            raise JBIG2Error("OOB strip T")
        strip_t = -dt0 * strips
        first_s = 0
        n_inst = 0
        while n_inst < num_instances:
            dt = dec.decode_int("IADT")
            if dt is None:
                raise JBIG2Error("OOB strip delta")
            strip_t += dt * strips
            dfs = dec.decode_int("IAFS")
            if dfs is None:
                raise JBIG2Error("OOB first S")
            first_s += dfs
            cur_s = first_s
            first = True
            while True:
                if not first:
                    ids = dec.decode_int("IADS")
                    if ids is None:
                        break               # end of strip
                    cur_s += ids + ds_offset
                first = False
                if n_inst >= num_instances:
                    break
                cur_t = 0 if strips == 1 else dec.decode_int("IAIT")
                if cur_t is None:
                    raise JBIG2Error("OOB T offset")
                t_i = strip_t + cur_t
                sid = dec.decode_iaid(symcodelen)
                if not 0 <= sid < len(syms):
                    raise JBIG2Error(f"symbol id {sid} out of range")
                sym = syms[sid]
                if sbrefine:
                    # per-instance refinement (6.4.11): RI flag, then
                    # size deltas + offsets; the instance bitmap
                    # refines the symbol with the 6.4.11 center shift
                    ri = dec.decode_int("IARI")
                    if ri is None:
                        raise JBIG2Error("OOB refinement flag")
                    if ri:
                        rdw = dec.decode_int("IARDW")
                        rdh = dec.decode_int("IARDH")
                        rdx = dec.decode_int("IARDX")
                        rdy = dec.decode_int("IARDY")
                        if None in (rdw, rdh, rdx, rdy):
                            raise JBIG2Error("OOB refinement deltas")
                        nw, nh = sym.shape[1] + rdw, sym.shape[0] + rdh
                        if not (0 < nw <= 1 << 20 and 0 < nh <= 1 << 20):
                            raise JBIG2Error("bad refined instance size")
                        sym = dec.decode_refine(
                            nw, nh, sym, template=sbrtemplate, at=rat,
                            dx=(rdw >> 1) + rdx, dy=(rdh >> 1) + rdy)
                sh, sw = sym.shape
                if (not transposed) and ref_corner in (2, 3):
                    cur_s += sw - 1         # pre-advance (3c vi)
                elif transposed and ref_corner in (0, 2):
                    cur_s += sh - 1
                draw(sym, cur_s, t_i)
                if (not transposed) and ref_corner in (0, 1):
                    cur_s += sw - 1         # post-advance (3c x)
                elif transposed and ref_corner in (1, 3):
                    cur_s += sh - 1
                n_inst += 1
    return x, y, ext_op, region


def _decode_text_region_huffman(payload: bytes, syms: List[np.ndarray],
                                tables: List["_HuffTable"], pos: int,
                                info, log_strips: int, ref_corner: int,
                                transposed: int, comb_op: int,
                                def_pixel: int, ds_offset: int,
                                ) -> Tuple[int, int, int, np.ndarray]:
    """SBHUFF=1 text region body (T.88 6.4 + §7.4.4.1): the 16-bit
    Huffman-flags word selects FS/DS/DT (and refinement/RSIZE) tables;
    the symbol-ID table is runcode-coded (§7.4.4.1.4, 35 four-bit
    runcode lengths, repeats 32/33/34), byte-aligned before instances."""
    w, h, x, y, ext_op = info
    if len(payload) < pos + 6:
        raise JBIG2Error("short huffman text region")
    hflags = struct.unpack(">H", payload[pos:pos + 2])[0]
    pos += 2
    customs = list(tables)
    fs_t = _select_table(hflags & 3, {0: 6, 1: 7}, 3, customs,
                         "SBHUFFFS")
    ds_t = _select_table((hflags >> 2) & 3, {0: 8, 1: 9, 2: 10}, 3,
                         customs, "SBHUFFDS")
    dt_t = _select_table((hflags >> 4) & 3, {0: 11, 1: 12, 2: 13}, 3,
                         customs, "SBHUFFDT")
    # refinement tables are unused with SBREFINE=0 but still consume
    # their referred custom slots in flag order (§7.4.4.1.6)
    for shift, what in ((6, "SBHUFFRDW"), (8, "SBHUFFRDH"),
                        (10, "SBHUFFRDX"), (12, "SBHUFFRDY")):
        if (hflags >> shift) & 3 == 3:
            _select_table(3, {}, 3, customs, what)
    if (hflags >> 14) & 1:
        _select_table(1, {0: 1}, 1, customs, "SBHUFFRSIZE")

    num_instances = struct.unpack(">I", payload[pos:pos + 4])[0]
    pos += 4
    if num_instances > 10 * _MAX_SYMBOLS:
        raise JBIG2Error(f"instance count out of range ({num_instances})")
    if not syms:
        raise JBIG2Error("text region with no symbols")
    strips = 1 << log_strips

    br = _BitReader(payload[pos:])
    # symbol-ID code table (7.4.4.1.4): 35 runcode lengths of 4 bits,
    # runcodes canonical-coded, then per-symbol code lengths with
    # repeat codes 32 (prev, 2 bits + 3), 33 (zero, 3 bits + 3),
    # 34 (zero, 7 bits + 11)
    run_t = _HuffTable([(br.read(4), 0, i) for i in range(35)])
    lengths: List[int] = []
    prev = 0
    while len(lengths) < len(syms):
        rc = run_t.decode(br)
        if rc is None or rc > 34:
            raise JBIG2Error("bad symbol-ID runcode")
        if rc < 32:
            lengths.append(rc)
            prev = rc
        elif rc == 32:
            lengths.extend([prev] * (br.read(2) + 3))
        elif rc == 33:
            lengths.extend([0] * (br.read(3) + 3))
        else:
            lengths.extend([0] * (br.read(7) + 11))
    if len(lengths) != len(syms):
        raise JBIG2Error("symbol-ID length run overflow")
    sym_t = _HuffTable([(ln, 0, i) for i, ln in enumerate(lengths)])
    br.byte_align()

    region = np.full((h, w), def_pixel, np.uint8)

    def draw(sym: np.ndarray, s: int, t: int) -> None:
        """Blit mapped per REFCORNER / TRANSPOSED (6.4.5 step 3c viii),
        same mapping as the arithmetic path above."""
        sh, sw = sym.shape
        if transposed:
            ry = s if ref_corner in (1, 3) else s - sh + 1
            rx = t if ref_corner in (0, 1) else t - sw + 1
        else:
            rx = s if ref_corner in (0, 1) else s - sw + 1
            ry = t if ref_corner in (1, 3) else t - sh + 1
        x0, y0 = max(rx, 0), max(ry, 0)
        x1, y1 = min(rx + sw, w), min(ry + sh, h)
        if x0 >= x1 or y0 >= y1:
            return
        view = region[y0:y1, x0:x1]
        part = sym[y0 - ry:y1 - ry, x0 - rx:x1 - rx]
        if comb_op == 0:
            view |= part
        elif comb_op == 1:
            view &= part
        elif comb_op == 2:
            view ^= part
        else:
            view[...] = 1 - (view ^ part)

    dt0 = dt_t.decode(br)
    if dt0 is None:
        raise JBIG2Error("OOB strip T")
    strip_t = -dt0 * strips
    first_s = 0
    n_inst = 0
    while n_inst < num_instances:
        dt = dt_t.decode(br)
        if dt is None:
            raise JBIG2Error("OOB strip delta")
        strip_t += dt * strips
        dfs = fs_t.decode(br)
        if dfs is None:
            raise JBIG2Error("OOB first S")
        first_s += dfs
        cur_s = first_s
        first = True
        while True:
            if not first:
                ids = ds_t.decode(br)
                if ids is None:
                    break                   # end of strip (OOB)
                cur_s += ids + ds_offset
            first = False
            if n_inst >= num_instances:
                break
            t_i = strip_t + (br.read(log_strips) if strips > 1 else 0)
            sid = sym_t.decode(br)
            if sid is None or not 0 <= sid < len(syms):
                raise JBIG2Error(f"symbol id {sid} out of range")
            sym = syms[sid]
            sh, sw = sym.shape
            if (not transposed) and ref_corner in (2, 3):
                cur_s += sw - 1             # pre-advance (3c vi)
            elif transposed and ref_corner in (0, 2):
                cur_s += sh - 1
            draw(sym, cur_s, t_i)
            if (not transposed) and ref_corner in (0, 1):
                cur_s += sw - 1             # post-advance (3c x)
            elif transposed and ref_corner in (1, 3):
                cur_s += sh - 1
            n_inst += 1
    return x, y, ext_op, region


# ------------------------------------------- huffman coding (Annex B)
#
# Older scanner pipelines emit Huffman-coded symbol dictionaries and
# text regions instead of the MQ-arithmetic forms above (T.88 §6.5/§6.4
# with SDHUFF/SBHUFF = 1; generic regions have no Huffman form — their
# non-arithmetic variant is MMR, handled in decode_generic). Values are
# prefix codes from Annex B: fifteen standard tables selected by flag
# bits (§7.4.3.1.2 / §7.4.4.1.1) or custom tables carried in type-53
# code-table segments (§B.2), plus the runcode-coded symbol-ID table
# (§7.4.4.1.4).


class _BitReader:
    """MSB-first bit reader with byte alignment (Huffman-coded segment
    payloads; the MQ decoder above has its own state machine)."""

    def __init__(self, data: bytes):
        self.data = data
        self.bytepos = 0
        self.bitpos = 0

    def read_bit(self) -> int:
        if self.bytepos >= len(self.data):
            raise JBIG2Error("huffman data exhausted")
        b = (self.data[self.bytepos] >> (7 - self.bitpos)) & 1
        self.bitpos += 1
        if self.bitpos == 8:
            self.bitpos = 0
            self.bytepos += 1
        return b

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def byte_align(self) -> None:
        if self.bitpos:
            self.bitpos = 0
            self.bytepos += 1

    def skip_bytes(self, n: int) -> None:
        if self.bitpos:
            raise JBIG2Error("skip_bytes while bit-unaligned")
        self.bytepos += n


class _HuffTable:
    """One Annex B table: ``lines`` of (preflen, rangelen, rangelow,
    sign) with sign -1 for the lower-range line (value = low - offset),
    rangelen 32 = open 32-bit range. ``oob_preflen`` > 0 adds the
    out-of-band code (decode returns None). Codes are assigned by the
    canonical B.3 procedure in line order."""

    def __init__(self, lines, oob_preflen: int = 0):
        self.lines = [(p, r, lo, (s[0] if s else 1))
                      for p, r, lo, *s in lines]
        self.oob_preflen = oob_preflen
        codes: Dict[Tuple[int, int], int] = {}   # (len, code) -> line idx
        entries = [(p, i) for i, (p, _r, _lo, _s) in enumerate(self.lines)
                   if p > 0]
        if oob_preflen:
            entries.append((oob_preflen, -1))
        code = 0
        for length in range(1, 33):
            for p, idx in entries:
                if p == length:
                    codes[(length, code)] = idx
                    code += 1
            code <<= 1
        self.codes = codes

    def decode(self, br: _BitReader) -> Optional[int]:
        code = 0
        for length in range(1, 33):
            code = (code << 1) | br.read_bit()
            idx = self.codes.get((length, code))
            if idx is None:
                continue
            if idx == -1:
                return None                       # OOB
            _p, rangelen, low, sign = self.lines[idx]
            off = br.read(rangelen)
            return low + off if sign > 0 else low - off
        raise JBIG2Error("bad huffman code")

    def encode(self, bw: "_BitWriterMSB", v: Optional[int]) -> None:
        """Emit ``v`` via the first line whose range covers it (tests'
        fixture encoder; None = OOB)."""
        code_of = {idx: (ln, c) for (ln, c), idx in self.codes.items()}
        if v is None:
            if not self.oob_preflen:
                raise JBIG2Error("table has no OOB code")
            ln, c = code_of[-1]
            bw.put(c, ln)
            return
        for idx, (_p, rangelen, low, sign) in enumerate(self.lines):
            if sign > 0:
                hi = low + ((1 << rangelen) - 1) if rangelen < 32 else None
                ok = v >= low and (hi is None or v <= hi)
                off = v - low
            else:
                ok = v <= low
                off = low - v
            if ok and idx in code_of:
                ln, c = code_of[idx]
                bw.put(c, ln)
                bw.put(off, rangelen)
                return
        raise JBIG2Error(f"value {v} not covered by table")


# Annex B standard tables (B.1-B.15). Each: (lines, oob_preflen);
# line = (preflen, rangelen, rangelow[, sign]) with sign -1 marking the
# lower-range line.
_STD_TABLE_SPECS = {
    1: ([(1, 4, 0), (2, 8, 16), (3, 16, 272), (3, 32, 65808)], 0),
    2: ([(1, 0, 0), (2, 0, 1), (3, 0, 2), (4, 3, 3), (5, 6, 11),
         (6, 32, 75)], 6),
    3: ([(8, 8, -256), (1, 0, 0), (2, 0, 1), (3, 0, 2), (4, 3, 3),
         (5, 6, 11), (8, 32, -257, -1), (7, 32, 75)], 6),
    4: ([(1, 0, 1), (2, 0, 2), (3, 0, 3), (4, 3, 4), (5, 6, 12),
         (5, 32, 76)], 0),
    5: ([(7, 8, -255), (1, 0, 1), (2, 0, 2), (3, 0, 3), (4, 3, 4),
         (5, 6, 12), (7, 32, -256, -1), (6, 32, 76)], 0),
    6: ([(5, 10, -2048), (4, 9, -1024), (4, 8, -512), (4, 7, -256),
         (5, 6, -128), (5, 5, -64), (4, 5, -32), (2, 7, 0), (3, 7, 128),
         (3, 8, 256), (4, 9, 512), (4, 10, 1024), (6, 32, -2049, -1),
         (6, 32, 2048)], 0),
    7: ([(4, 9, -1024), (3, 8, -512), (4, 7, -256), (5, 6, -128),
         (5, 5, -64), (4, 5, -32), (4, 5, 0), (5, 5, 32), (5, 6, 64),
         (4, 7, 128), (3, 8, 256), (3, 9, 512), (3, 10, 1024),
         (5, 32, -1025, -1), (5, 32, 2048)], 0),
    8: ([(8, 3, -15), (9, 1, -7), (8, 1, -5), (9, 0, -3), (7, 0, -2),
         (4, 0, -1), (2, 1, 0), (5, 0, 2), (6, 0, 3), (3, 4, 4),
         (6, 1, 20), (4, 4, 22), (4, 5, 38), (5, 6, 70), (5, 7, 134),
         (6, 7, 262), (7, 8, 390), (6, 10, 646), (9, 32, -16, -1),
         (9, 32, 1670)], 2),
    9: ([(8, 4, -31), (9, 2, -15), (8, 2, -11), (9, 1, -7), (7, 1, -5),
         (4, 1, -3), (3, 1, -1), (3, 1, 1), (5, 1, 3), (6, 1, 5),
         (3, 5, 7), (6, 2, 39), (4, 5, 43), (4, 6, 75), (5, 7, 139),
         (5, 8, 267), (6, 8, 523), (7, 9, 779), (6, 11, 1291),
         (9, 32, -32, -1), (9, 32, 3339)], 2),
    10: ([(7, 4, -21), (8, 0, -5), (7, 0, -4), (5, 0, -3), (2, 2, -2),
          (5, 0, 2), (6, 0, 3), (7, 0, 4), (8, 0, 5), (2, 6, 6),
          (5, 5, 70), (6, 5, 102), (7, 6, 134), (8, 7, 198),
          (8, 8, 326), (8, 9, 582), (8, 10, 1094), (7, 11, 2118),
          (8, 32, -22, -1), (8, 32, 4166)], 2),
    11: ([(1, 0, 1), (2, 1, 2), (4, 0, 4), (4, 1, 5), (5, 1, 7),
          (5, 2, 9), (6, 2, 13), (7, 2, 17), (7, 3, 21), (7, 4, 29),
          (7, 5, 45), (7, 6, 77), (7, 32, 141)], 0),
    12: ([(1, 0, 1), (2, 0, 2), (3, 1, 3), (5, 0, 5), (5, 1, 6),
          (6, 1, 8), (7, 0, 10), (7, 1, 11), (7, 2, 13), (7, 3, 17),
          (7, 4, 25), (8, 5, 41), (8, 32, 73)], 0),
    13: ([(1, 0, 1), (3, 0, 2), (4, 0, 3), (5, 0, 4), (4, 1, 5),
          (3, 3, 7), (6, 1, 15), (6, 2, 17), (6, 3, 21), (6, 4, 29),
          (6, 5, 45), (7, 6, 77), (7, 32, 141)], 0),
    14: ([(3, 0, -2), (3, 0, -1), (1, 0, 0), (3, 0, 1), (3, 0, 2)], 0),
    15: ([(7, 4, -24), (6, 2, -8), (5, 1, -4), (4, 0, -2), (3, 0, -1),
          (1, 0, 0), (3, 0, 1), (4, 0, 2), (5, 1, 3), (6, 2, 5),
          (7, 4, 9), (7, 32, -25, -1), (7, 32, 25)], 0),
}
_STD_TABLES: Dict[int, _HuffTable] = {}


def _std_table(n: int) -> _HuffTable:
    t = _STD_TABLES.get(n)
    if t is None:
        lines, oob = _STD_TABLE_SPECS[n]
        t = _STD_TABLES[n] = _HuffTable(lines, oob)
    return t


def _parse_code_table(payload: bytes) -> _HuffTable:
    """Code-table segment (type 53) -> _HuffTable (T.88 §B.2)."""
    if len(payload) < 9:
        raise JBIG2Error("short code table segment")
    flags = payload[0]
    htoob = flags & 1
    htps = ((flags >> 1) & 7) + 1
    htrs = ((flags >> 4) & 7) + 1
    htlow, hthigh = struct.unpack(">ii", payload[1:9])
    if hthigh <= htlow:
        raise JBIG2Error("bad code table range")
    br = _BitReader(payload[9:])
    lines = []
    cur = htlow
    while cur < hthigh:
        pref = br.read(htps)
        rng = br.read(htrs)
        lines.append((pref, rng, cur, 1))
        if rng >= 32:
            raise JBIG2Error("bad code table range length")
        cur += 1 << rng
        if len(lines) > 4096:
            raise JBIG2Error("code table too long")
    lines.append((br.read(htps), 32, htlow - 1, -1))     # lower range
    lines.append((br.read(htps), 32, hthigh, 1))         # upper range
    oob = br.read(htps) if htoob else 0
    return _HuffTable(lines, oob)


def _select_table(sel: int, mapping: Dict[int, int], custom_sel: int,
                  customs: List["_HuffTable"], what: str) -> "_HuffTable":
    """Flag-bit table selection (§7.4.3.1.2 / §7.4.4.1.1): `mapping`
    maps selector values to standard table numbers; `custom_sel` (3 for
    2-bit fields, 1 for 1-bit fields) takes the next referred custom
    table — they are consumed in flag order (§7.4.3.1.6)."""
    if sel in mapping:
        return _std_table(mapping[sel])
    if sel == custom_sel:
        if not customs:
            raise JBIG2Error(f"{what} wants a custom table but none "
                             "referred")
        return customs.pop(0)
    raise JBIG2Error(f"bad {what} table selector {sel}")


class _BitWriterMSB:
    """MSB-first bit writer (fixture encoders for the Huffman paths)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, v: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                self.acc = 0
                self.n = 0

    def byte_align(self) -> None:
        while self.n:
            self.put(0, 1)

    def raw_bytes(self, b: bytes) -> None:
        self.byte_align()
        self.out += b

    def flush(self) -> bytes:
        self.byte_align()
        return bytes(self.out)


# ----------------------------------------------------- segment parsing

def _parse_segments(data: bytes
                    ) -> Iterator[Tuple[int, int, int, bytes, List[int]]]:
    """Embedded-format segment stream ->
    (number, type, page, payload, referred-segment numbers)."""
    pos, n = 0, len(data)
    while pos < n:
        if pos + 11 > n:
            raise JBIG2Error("truncated segment header")
        num = struct.unpack(">I", data[pos:pos + 4])[0]
        flags = data[pos + 4]
        stype = flags & 0x3F
        pos += 5
        rts = data[pos]
        count = rts >> 5
        if count == 7:
            count = struct.unpack(">I", data[pos:pos + 4])[0] & 0x1FFFFFFF
            pos += 4 + (count + 8) // 8       # long form + retain bits
        else:
            pos += 1
        ref_size = 1 if num <= 256 else (2 if num <= 65536 else 4)
        refs = []
        for _ in range(count):
            chunk = data[pos:pos + ref_size]
            refs.append(int.from_bytes(chunk, "big"))
            pos += ref_size
        if flags & 0x40:
            page = struct.unpack(">I", data[pos:pos + 4])[0]
            pos += 4
        else:
            page = data[pos]
            pos += 1
        if pos + 4 > n:
            raise JBIG2Error("truncated segment length")
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        pos += 4
        if length == 0xFFFFFFFF:
            raise JBIG2Error("unknown-length segment (unsupported)")
        if pos + length > n:
            raise JBIG2Error("segment data past end of stream")
        yield num, stype, page, data[pos:pos + length], refs
        pos += length


def _region_info(payload: bytes) -> Tuple[int, int, int, int, int]:
    if len(payload) < 17:
        raise JBIG2Error("short region segment info")
    w, h, x, y = struct.unpack(">IIII", payload[:16])
    return w, h, x, y, payload[16] & 0x7


_UNSUPPORTED_TYPES = {
    7: "text region (unknown subtype)",
}


def _composite(page: np.ndarray, x: int, y: int, op: int,
               bmp: np.ndarray) -> None:
    """One region onto the page with its external combination operator
    (T.88 7.4.8.5; 4 = REPLACE)."""
    page_h, page_w = page.shape
    h, w = bmp.shape
    if y + h > page_h or x + w > page_w:
        bmp = bmp[:max(0, page_h - y), :max(0, page_w - x)]
        h, w = bmp.shape
        if h == 0 or w == 0:
            return
    view = page[y:y + h, x:x + w]
    if op == 0:
        view |= bmp
    elif op == 1:
        view &= bmp
    elif op == 2:
        view ^= bmp
    elif op == 3:
        view[...] = 1 - (view ^ bmp)
    else:                                            # REPLACE
        view[...] = bmp


def decode_embedded(data: bytes, globals_data: bytes = b"") -> np.ndarray:
    """PDF-embedded JBIG2 (+ optional JBIG2Globals) -> page bitmap
    (height, width) uint8, 1 = black ink.

    Covers generic regions (36/38/39), symbol dictionaries (0), text
    regions (4/5/6), pattern dictionaries (16), halftone regions
    (20/22/23) and page-refinement regions (40/42/43) — the segments
    scanner pipelines emit. Huffman-coded variants raise, keeping the
    pdf_rasterizer-hook fallback."""
    segments = list(_parse_segments(globals_data)) if globals_data else []
    segments += list(_parse_segments(data))

    page_w = page_h = 0
    page_default = 0
    regions: List[Tuple[int, int, int, np.ndarray]] = []
    page_arr: Optional[np.ndarray] = None
    # segment number -> exported symbols of that symbol dictionary
    sym_dicts: Dict[int, List[np.ndarray]] = {}
    # segment number -> patterns of that pattern dictionary
    pat_dicts: Dict[int, List[np.ndarray]] = {}
    # segment number -> custom Huffman table (type 53, Annex B.2)
    code_tables: Dict[int, _HuffTable] = {}

    def materialize_page() -> np.ndarray:
        """Flush collected regions onto an eager page bitmap — needed
        as soon as a segment (refinement) must READ page content; the
        deferred path stays for striped/absent page headers whose size
        is only known after all regions decode."""
        nonlocal page_arr
        if page_arr is None:
            if page_w == 0 or page_h in (0, 0xFFFFFFFF):
                raise JBIG2Error(
                    "refinement region before a sized page info segment")
            if page_w * page_h > MAX_PIXELS:
                raise JBIG2Error(
                    f"page too large ({page_w}x{page_h} > {MAX_PIXELS} px)")
            page_arr = np.full((page_h, page_w), page_default, np.uint8)
        for rx, ry, rop, rbmp in regions:
            _composite(page_arr, rx, ry, rop, rbmp)
        regions.clear()
        return page_arr

    for num, stype, _page, payload, refs in segments:
        if stype == 48:                              # page info
            if len(payload) < 17:
                raise JBIG2Error("short page info segment")
            page_w, page_h = struct.unpack(">II", payload[:8])
            page_default = (payload[16] >> 2) & 1
        elif stype == 0:                             # symbol dictionary
            inputs: List[np.ndarray] = []
            for r in refs:
                inputs.extend(sym_dicts.get(r, []))
            tabs = [code_tables[r] for r in refs if r in code_tables]
            sym_dicts[num] = _decode_symbol_dict(payload, inputs, tabs)
        elif stype == 16:                            # pattern dictionary
            pat_dicts[num] = _decode_pattern_dict(payload)
        elif stype in (20, 22, 23):                  # halftone region
            pats: List[np.ndarray] = []
            for r in refs:
                pats.extend(pat_dicts.get(r, []))
            if not pats:                             # unreferenced dicts
                for plist in pat_dicts.values():
                    pats.extend(plist)
            x, y, op, bmp = _decode_halftone_region(payload, pats)
            regions.append((x, y, op, bmp))
        elif stype in (4, 5, 6):                     # text region
            syms: List[np.ndarray] = []
            for r in refs:
                syms.extend(sym_dicts.get(r, []))
            if not syms:                             # unreferenced dicts
                for exported in sym_dicts.values():
                    syms.extend(exported)
            tabs = [code_tables[r] for r in refs if r in code_tables]
            x, y, op, bmp = _decode_text_region(payload, syms, tabs)
            regions.append((x, y, op, bmp))
        elif stype in (36, 38, 39):                  # generic region
            w, h, x, y, op = _region_info(payload)
            gflags = payload[17]
            mmr = bool(gflags & 1)
            template = (gflags >> 1) & 3
            tpgdon = bool(gflags & 8)
            if gflags & 0x10:
                raise JBIG2Error("EXTTEMPLATE generic region (unsupported)")
            pos = 18
            at = None
            if not mmr:
                nat = 4 if template == 0 else 1
                at = []
                for i in range(nat):
                    ax, ay = struct.unpack(
                        ">bb", payload[pos + 2 * i:pos + 2 * i + 2])
                    at.append((ax, ay))
                pos += 2 * nat
            bmp = decode_generic(payload[pos:], w, h, template=template,
                                 tpgdon=tpgdon, at=at, mmr=mmr)
            regions.append((x, y, op, bmp))
        elif stype in (40, 42, 43):                  # refinement region
            w, h, x, y, op = _region_info(payload)
            if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
                raise JBIG2Error(f"bad refinement region size {w}x{h}")
            if len(payload) < 18:
                raise JBIG2Error("short refinement region")
            rflags = payload[17]
            template = rflags & 1
            if (rflags >> 1) & 1:
                raise JBIG2Error("TPGRON refinement (unsupported)")
            pos = 18
            rat = [(-1, -1), (-1, -1)]
            if template == 0:
                rat = [struct.unpack(">bb", payload[pos:pos + 2]),
                       struct.unpack(">bb", payload[pos + 2:pos + 4])]
                pos += 4
            # reference = the page contents under the region (7.4.7.2:
            # no intermediate-region refs -> refine against the page)
            cur = materialize_page()
            ref = np.zeros((h, w), np.uint8)
            x1 = min(x + w, cur.shape[1])
            y1 = min(y + h, cur.shape[0])
            if x < x1 and y < y1:
                ref[:y1 - y, :x1 - x] = cur[y:y1, x:x1]
            with _ArithDecoder(payload[pos:]) as dec:
                bmp = dec.decode_refine(w, h, ref, template=template,
                                        at=rat)
            regions.append((x, y, op, bmp))
        elif stype == 53:                            # code table (B.2)
            code_tables[num] = _parse_code_table(payload)
        elif stype in _UNSUPPORTED_TYPES:
            raise JBIG2Error(
                f"unsupported JBIG2 feature: {_UNSUPPORTED_TYPES[stype]}")
        # 49-52 (end-of-*, profiles), 62 (extension): no-ops here

    if page_arr is not None:                         # eager path engaged
        for x, y, op, bmp in regions:
            _composite(page_arr, x, y, op, bmp)
        return page_arr
    if not regions:
        raise JBIG2Error("no decodable regions")
    if page_w == 0 or page_h in (0, 0xFFFFFFFF):     # striped/absent page
        page_w = max([page_w] + [x + b.shape[1] for x, _y, _o, b in regions])
        page_h = max(y + b.shape[0] for _x, y, _o, b in regions)
    if page_w * page_h > MAX_PIXELS:
        raise JBIG2Error(
            f"page too large ({page_w}x{page_h} > {MAX_PIXELS} px)")
    page = np.full((page_h, page_w), page_default, np.uint8)
    for x, y, op, bmp in regions:
        _composite(page, x, y, op, bmp)
    return page


def decode_jbig2_params(data: bytes, globals_data: bytes,
                        width: int, height: int) -> Optional[bytes]:
    """PDF filter adapter: 1-bpc gray samples (0 = black, the PNG
    wrap's convention, like ccitt.decode_ccitt_params) or None."""
    try:
        page = decode_embedded(data, globals_data)
    except JBIG2Error:
        return None
    h, w = page.shape
    if width and w > width:
        page = page[:, :width]
    if height and h > height:
        page = page[:height]
    h, w = page.shape
    if width and w < width:
        page = np.pad(page, ((0, 0), (0, width - w)))
    if height and h < height:
        page = np.pad(page, ((0, height - h), (0, 0)))
    packed = np.packbits(page, axis=1)
    return bytes((~packed).astype(np.uint8).tobytes())


# --------------------------------------------------- encoder (fixtures)

_QE = [0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
       0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
       0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
       0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
       0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601]
_NMPS = [1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18,
         19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
         35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46]
_NLPS = [1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15,
         16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
         31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46]
_SWITCH = [1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0,
           0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
           0, 0, 0, 0, 0]


class _MQEncoder:
    """T.88 Annex E encoder (software conventions), fixture-grade."""

    def __init__(self):
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.out = bytearray(b"\x00")                # dummy B, stripped

    def encode(self, cx: List[int], bit: int) -> None:
        i, mps = cx
        q = _QE[i]
        self.a -= q
        if bit == mps:
            if self.a & 0x8000:
                self.c += q
                return
            if self.a < q:
                self.a = q
            else:
                self.c += q
            cx[0] = _NMPS[i]
        else:
            if self.a < q:
                self.c += q
            else:
                self.a = q
            if _SWITCH[i]:
                cx[1] ^= 1
            cx[0] = _NLPS[i]
        while True:                                  # RENORME
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _byteout(self) -> None:
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def flush(self) -> bytes:
        tempc = self.c + self.a                      # SETBITS (E.9)
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFFF
        self._byteout()
        if self.out[-1] != 0xFF:
            self.out.append(0xFF)
        self.out.append(0xAC)
        return bytes(self.out[1:])


def _generic_encode_into(enc: "_MQEncoder", cx: dict, bitmap: np.ndarray,
                         *, template: int = 0, tpgdon: bool = False,
                         at: Optional[List[Tuple[int, int]]] = None) -> None:
    """MQ-encode one bitmap on a caller's stream + GB context bank."""
    bitmap = np.asarray(bitmap, np.uint8)
    h, w = bitmap.shape
    tmpl = sorted(_CODING_TEMPLATE[template] + list(at or
                                                    _NOMINAL_AT[template]),
                  key=lambda p: (p[1], p[0]))

    def bit_at(px: int, py: int) -> int:
        if 0 <= px < w and 0 <= py < h:
            return int(bitmap[py, px])
        return 0

    ltp = 0
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        if tpgdon:
            typical = int(np.array_equal(bitmap[y], prev))
            sltp = ltp ^ typical
            enc.encode(cx.setdefault(_SLTP_CTX[template], [0, 0]), sltp)
            ltp = typical
            prev = bitmap[y]
            if ltp:
                continue
        for x in range(w):
            ctx = 0
            for dx, dy in tmpl:
                ctx = (ctx << 1) | bit_at(x + dx, y + dy)
            enc.encode(cx.setdefault(ctx, [0, 0]), int(bitmap[y, x]))
        prev = bitmap[y]


def encode_generic(bitmap: np.ndarray, *, template: int = 0,
                   tpgdon: bool = False) -> bytes:
    """MQ-encode a (h, w) 0/1 bitmap as generic-region data (nominal
    AT pixels) — the exact inverse of decode_generic."""
    enc = _MQEncoder()
    _generic_encode_into(enc, {}, bitmap, template=template, tpgdon=tpgdon)
    return enc.flush()


class _ArithEncoder:
    """One MQ stream + Annex-A integer/ID encoders over it — the exact
    inverse of `_ArithDecoder`, for symbol/text fixtures."""

    def __init__(self):
        self.enc = _MQEncoder()
        self._int_cx: Dict[str, dict] = {}
        self._iaid_cx: dict = {}
        self.gb_cx: dict = {}
        self.gr_cx: dict = {}

    def encode_int(self, name: str, v: Optional[int]) -> None:
        """A.2 inverse; v=None encodes OOB (sign=1, magnitude 0)."""
        cxs = self._int_cx.setdefault(name, {})
        prev = 1

        def bit(b: int) -> None:
            nonlocal prev
            self.enc.encode(cxs.setdefault(prev, [0, 0]), b)
            prev = ((prev << 1) | b if prev < 256
                    else (((prev << 1) | b) & 511) | 256)

        if v is None:
            s, av = 1, 0
        else:
            s, av = (1, -v) if v < 0 else (0, v)
        bit(s)
        for bound, prefix, nbits, off in (
                (4, (0,), 2, 0), (20, (1, 0), 4, 4),
                (84, (1, 1, 0), 6, 20), (340, (1, 1, 1, 0), 8, 84),
                (4436, (1, 1, 1, 1, 0), 12, 340),
                (None, (1, 1, 1, 1, 1), 32, 4436)):
            if bound is None or av < bound:
                for p in prefix:
                    bit(p)
                rem = av - off
                for i in range(nbits - 1, -1, -1):
                    bit((rem >> i) & 1)
                return

    def encode_iaid(self, sid: int, symcodelen: int) -> None:
        prev = 1
        for i in range(symcodelen - 1, -1, -1):
            b = (sid >> i) & 1
            self.enc.encode(self._iaid_cx.setdefault(prev, [0, 0]), b)
            prev = (prev << 1) | b

    def encode_generic(self, bitmap: np.ndarray, *, template: int = 0,
                       at: Optional[List[Tuple[int, int]]] = None) -> None:
        _generic_encode_into(self.enc, self.gb_cx, bitmap,
                             template=template, at=at)

    def encode_refine(self, bitmap: np.ndarray, ref: np.ndarray, *,
                      template: int = 0,
                      at: Optional[List[Tuple[int, int]]] = None,
                      dx: int = 0, dy: int = 0) -> None:
        """Inverse of `_ArithDecoder.decode_refine` — context bits are
        coding-template pixels (already-coded target) then
        reference-template pixels, in the C decoder's list order."""
        bitmap = np.asarray(bitmap, np.uint8)
        ref = np.asarray(ref, np.uint8)
        at = at or [(-1, -1), (-1, -1)]
        if template == 0:
            ct = [(0, -1), (1, -1), (-1, 0), tuple(at[0])]
            rt = [(0, -1), (1, -1), (-1, 0), (0, 0), (1, 0),
                  (-1, 1), (0, 1), (1, 1), tuple(at[1])]
        else:
            ct = [(-1, -1), (0, -1), (1, -1), (-1, 0)]
            rt = [(0, -1), (-1, 0), (0, 0), (1, 0), (0, 1), (1, 1)]
        h, w = bitmap.shape
        rh, rw = ref.shape
        cx = self.gr_cx
        for y in range(h):
            for x in range(w):
                ctx = 0
                for ddx, ddy in ct:
                    px, py = x + ddx, y + ddy
                    bit = (int(bitmap[py, px])
                           if 0 <= px < w and 0 <= py < h else 0)
                    ctx = (ctx << 1) | bit
                for ddx, ddy in rt:
                    px, py = x + ddx - dx, y + ddy - dy
                    bit = (int(ref[py, px])
                           if 0 <= px < rw and 0 <= py < rh else 0)
                    ctx = (ctx << 1) | bit
                self.enc.encode(cx.setdefault(ctx, [0, 0]),
                                int(bitmap[y, x]))

    def flush(self) -> bytes:
        return self.enc.flush()


def encode_symbol_text(symbols: List[np.ndarray],
                       placements: List[Tuple[int, int, int]],
                       page_w: int, page_h: int) -> bytes:
    """Fixture encoder for the symbol-coded path: wrap glyph bitmaps +
    (sym_id, x, y) top-left placements as page info + symbol dictionary
    (type 0) + immediate lossless text region (type 6, referring to the
    dictionary) + end-of-page — the exact structure jbig2enc-style
    scanners emit, inverse of `_decode_symbol_dict`/`_decode_text_region`.

    A placement may also be ``(sym_id, x, y, target_bitmap)``: that
    instance is SBREFINE-coded (6.4.11) — the target refines the
    dictionary symbol in-stream, sizes may differ.
    """
    n = len(symbols)
    if n == 0:
        raise JBIG2Error("no symbols")
    symbols = [np.asarray(s, np.uint8) for s in symbols]

    # ---- symbol dictionary: group by height (ascending), widths within
    order = sorted(range(n), key=lambda i: (symbols[i].shape[0],
                                            symbols[i].shape[1], i))
    export_id = {orig: pos for pos, orig in enumerate(order)}
    senc = _ArithEncoder()
    hc_height = 0
    i = 0
    while i < n:
        h = symbols[order[i]].shape[0]
        senc.encode_int("IADH", h - hc_height)
        hc_height = h
        sym_width = 0
        while i < n and symbols[order[i]].shape[0] == h:
            w = symbols[order[i]].shape[1]
            senc.encode_int("IADW", w - sym_width)
            sym_width = w
            senc.encode_generic(symbols[order[i]])
            i += 1
        senc.encode_int("IADW", None)                # end height class
    senc.encode_int("IAEX", 0)                       # skip none
    senc.encode_int("IAEX", n)                       # export all
    sd_flags = 0                                     # arith, template 0
    at = b"".join(struct.pack(">bb", ax, ay) for ax, ay in _NOMINAL_AT[0])
    sd_payload = (struct.pack(">H", sd_flags) + at
                  + struct.pack(">II", n, n) + senc.flush())

    # ---- text region: strips of height 1, TOPLEFT corners
    symcodelen = max(1, (n - 1).bit_length())
    any_refined = any(len(p) > 3 for p in placements)
    tenc = _ArithEncoder()
    by_pos = sorted(placements, key=lambda p: (p[2], p[1]))
    tenc.encode_int("IADT", 0)                       # STRIPT = 0
    prev_t = 0
    first_s = 0
    j = 0
    rat = [(-1, -1), (-1, -1)]
    while j < len(by_pos):
        t = by_pos[j][2]
        tenc.encode_int("IADT", t - prev_t)
        prev_t = t
        cur_s = None
        while j < len(by_pos) and by_pos[j][2] == t:
            sid, x, _y = by_pos[j][:3]
            target = by_pos[j][3] if len(by_pos[j]) > 3 else None
            inst = (np.asarray(target, np.uint8) if target is not None
                    else symbols[sid])
            wj = inst.shape[1]
            if cur_s is None:
                tenc.encode_int("IAFS", x - first_s)
                first_s = x
            else:
                tenc.encode_int("IADS", x - cur_s)
            tenc.encode_iaid(export_id[sid], symcodelen)
            if any_refined:
                tenc.encode_int("IARI", 1 if target is not None else 0)
                if target is not None:
                    sym = symbols[sid]
                    rdw = inst.shape[1] - sym.shape[1]
                    rdh = inst.shape[0] - sym.shape[0]
                    tenc.encode_int("IARDW", rdw)
                    tenc.encode_int("IARDH", rdh)
                    tenc.encode_int("IARDX", 0)
                    tenc.encode_int("IARDY", 0)
                    tenc.encode_refine(inst, sym, template=0, at=rat,
                                       dx=rdw >> 1, dy=rdh >> 1)
            cur_s = x + wj - 1                       # TL post-advance
            j += 1
        tenc.encode_int("IADS", None)                # end of strip
    tr_flags = (1 << 4) | (2 if any_refined else 0)  # TOPLEFT, SBREFINE
    region_info = struct.pack(">IIII", page_w, page_h, 0, 0) + b"\x00"
    tr_payload = region_info + struct.pack(">H", tr_flags)
    if any_refined:                                   # SBRAT, template 0
        tr_payload += b"".join(struct.pack(">bb", ax, ay) for ax, ay in rat)
    tr_payload += struct.pack(">I", len(by_pos)) + tenc.flush()

    page_info = (struct.pack(">IIII", page_w, page_h, 0, 0)
                 + b"\x01" + b"\x00\x00")
    return (_segment(0, 48, 1, page_info)
            + _segment(1, 0, 1, sd_payload)
            + _segment(2, 6, 1, tr_payload, refs=(1,))
            + _segment(3, 49, 1, b""))


def encode_symbol_text_huffman(symbols: List[np.ndarray],
                               placements: List[Tuple[int, int, int]],
                               page_w: int, page_h: int, *,
                               custom_ds: bool = False) -> bytes:
    """Fixture encoder for the HUFFMAN-coded symbol path (SDHUFF=1 +
    SBHUFF=1) — what pre-jbig2enc scanner firmware emits. Standard
    Annex B tables (DH=B.4, DW=B.2, BMSIZE/EX=B.1; FS=B.6, DS=B.8,
    DT=B.11), collective bitmaps stored uncompressed (BMSIZE=0, §6.5.9),
    symbol-ID table runcode-coded (§7.4.4.1.4). ``custom_ds`` instead
    routes DS through a custom code-table segment (type 53, §B.2) to
    exercise the referred-table path. Inverse of
    `_decode_symbol_dict_huffman`/`_decode_text_region_huffman`."""
    n = len(symbols)
    if n == 0:
        raise JBIG2Error("no symbols")
    symbols = [np.asarray(s, np.uint8) for s in symbols]

    # ---- symbol dictionary (SDHUFF=1): heights ascending
    order = sorted(range(n), key=lambda i: (symbols[i].shape[0],
                                            symbols[i].shape[1], i))
    export_id = {orig: pos for pos, orig in enumerate(order)}
    dh_t, dw_t, bm_t, ex_t = (_std_table(4), _std_table(2),
                              _std_table(1), _std_table(1))
    bw = _BitWriterMSB()
    hc_height = 0
    i = 0
    while i < n:
        h = symbols[order[i]].shape[0]
        dh_t.encode(bw, h - hc_height)            # B.4 needs delta >= 1
        hc_height = h
        cls = []
        sym_width = 0
        while i < n and symbols[order[i]].shape[0] == h:
            w = symbols[order[i]].shape[1]
            dw_t.encode(bw, w - sym_width)        # B.2: delta >= 0
            sym_width = w
            cls.append(symbols[order[i]])
            i += 1
        dw_t.encode(bw, None)                     # OOB: end height class
        bm_t.encode(bw, 0)                        # BMSIZE 0: uncompressed
        coll = np.concatenate(cls, axis=1)        # (h, totwidth)
        bw.raw_bytes(np.packbits(coll, axis=1).tobytes())
    ex_t.encode(bw, 0)                            # skip none
    ex_t.encode(bw, n)                            # export all
    sd_flags = 1                                  # SDHUFF, all std tables
    sd_payload = (struct.pack(">H", sd_flags)
                  + struct.pack(">II", n, n) + bw.flush())

    # ---- optional custom DS table (type 53): complete prefix code
    # {len1: main range, len3: tail, len4: lower/upper, len2: OOB} —
    # Kraft 1/2+1/8+1/16+1/16+1/4 = 1
    ds_custom = _HuffTable([(1, 8, -16), (3, 4, 240),
                            (4, 32, -17, -1), (4, 32, 256)], 2)
    tbl_payload = b""
    if custom_ds:
        tw = _BitWriterMSB()
        for pref, rng in ((1, 8), (3, 4)):        # lines LOW..HIGH
            tw.put(pref, 4)
            tw.put(rng, 4)
        tw.put(4, 4)                              # lower-range preflen
        tw.put(4, 4)                              # upper-range preflen
        tw.put(2, 4)                              # OOB preflen
        tbl_payload = (bytes([1 | (3 << 1) | (3 << 4)])   # HTOOB, PS4, RS4
                       + struct.pack(">ii", -16, 256) + tw.flush())

    # ---- text region (SBHUFF=1): strips of height 1, TOPLEFT
    fs_t, dt_t = _std_table(6), _std_table(11)
    ds_t = ds_custom if custom_ds else _std_table(8)
    symcodelen = max(1, (n - 1).bit_length())
    tw = _BitWriterMSB()
    # runcode lengths (35 x 4 bits): only runcode `symcodelen` coded,
    # with prefix length 1 -> every symbol's length field is one 0-bit
    for rc in range(35):
        tw.put(1 if rc == symcodelen else 0, 4)
    for _ in range(n):
        tw.put(0, 1)                              # runcode -> symcodelen
    tw.byte_align()
    by_pos = sorted(placements, key=lambda p: (p[2], p[1]))
    dt_t.encode(tw, 1)                            # STRIPT = -1 (B.11 >= 1)
    prev_t = -1
    first_s = 0
    j = 0
    while j < len(by_pos):
        t = by_pos[j][2]
        dt_t.encode(tw, t - prev_t)               # >= 1 per sorted order
        prev_t = t
        cur_s = None
        while j < len(by_pos) and by_pos[j][2] == t:
            sid, x, _y = by_pos[j][:3]
            wj = symbols[sid].shape[1]
            if cur_s is None:
                fs_t.encode(tw, x - first_s)
                first_s = x
            else:
                ds_t.encode(tw, x - cur_s)
            tw.put(export_id[sid], symcodelen)
            cur_s = x + wj - 1                    # TL post-advance
            j += 1
        ds_t.encode(tw, None)                     # OOB: end of strip
    tr_flags = 1 | (1 << 4)                       # SBHUFF, TOPLEFT
    hflags = (3 << 2) if custom_ds else 0         # DS selector
    region_info = struct.pack(">IIII", page_w, page_h, 0, 0) + b"\x00"
    tr_payload = (region_info + struct.pack(">H", tr_flags)
                  + struct.pack(">H", hflags)
                  + struct.pack(">I", len(by_pos)) + tw.flush())

    page_info = (struct.pack(">IIII", page_w, page_h, 0, 0)
                 + b"\x01" + b"\x00\x00")
    out = _segment(0, 48, 1, page_info)
    out += _segment(1, 0, 1, sd_payload)
    if custom_ds:
        out += _segment(2, 53, 1, tbl_payload)
        out += _segment(3, 6, 1, tr_payload, refs=(1, 2))
        out += _segment(4, 49, 1, b"")
    else:
        out += _segment(2, 6, 1, tr_payload, refs=(1,))
        out += _segment(3, 49, 1, b"")
    return out


def encode_refined_page(base: np.ndarray, final: np.ndarray, *,
                        template: int = 0) -> bytes:
    """Fixture encoder for the refinement path: page info + a generic
    region carrying ``base`` (the lossy pass) + an immediate lossless
    refinement region (type 43, REPLACE) that corrects the page to
    ``final`` — the exact structure a lossy-then-refine encoder emits,
    inverse of the type-40/42/43 branch in `decode_embedded`."""
    base = np.asarray(base, np.uint8)
    final = np.asarray(final, np.uint8)
    if base.shape != final.shape:
        raise JBIG2Error("base/final size mismatch")
    h, w = base.shape
    page_info = struct.pack(">IIII", w, h, 0, 0) + b"\x01" + b"\x00\x00"
    g_at = b"".join(struct.pack(">bb", ax, ay) for ax, ay in _NOMINAL_AT[0])
    g_payload = (struct.pack(">IIII", w, h, 0, 0) + b"\x00"
                 + bytes([0]) + g_at + encode_generic(base))
    renc = _ArithEncoder()
    r_at = [(-1, -1), (-1, -1)]
    renc.encode_refine(final, base, template=template, at=r_at)
    r_flags = bytes([template & 1])
    r_head = struct.pack(">IIII", w, h, 0, 0) + bytes([4])  # REPLACE
    r_payload = r_head + r_flags
    if template == 0:
        r_payload += b"".join(struct.pack(">bb", ax, ay) for ax, ay in r_at)
    r_payload += renc.flush()
    return (_segment(0, 48, 1, page_info)
            + _segment(1, 39, 1, g_payload)
            + _segment(2, 43, 1, r_payload)
            + _segment(3, 49, 1, b""))


def encode_halftone(gray: np.ndarray, patterns: List[np.ndarray],
                    *, page_w: int, page_h: int,
                    hgx: int = 0, hgy: int = 0,
                    hrx: Optional[int] = None,
                    hry: int = 0) -> bytes:
    """Fixture encoder for the halftone path: wrap a (HGH, HGW) gray
    index image + pattern bitmaps as page info + pattern dictionary
    (type 16) + immediate lossless halftone region (type 23, referring
    to the dictionary) + end-of-page — the exact inverse of
    `_decode_pattern_dict`/`_decode_halftone_region`."""
    patterns = [np.asarray(p, np.uint8) for p in patterns]
    if not patterns:
        raise JBIG2Error("no patterns")
    ph, pw = patterns[0].shape
    if any(p.shape != (ph, pw) for p in patterns):
        raise JBIG2Error("patterns must share one size")
    if pw > 127:
        raise JBIG2Error("pattern wider than the AT1 reach (127)")
    gray = np.asarray(gray, np.int32)
    hgh, hgw = gray.shape
    n = len(patterns)
    if gray.min() < 0 or gray.max() >= n:
        raise JBIG2Error("gray indices out of pattern range")

    # ---- pattern dictionary: one collective bitmap, AT1 = (-HDPW, 0)
    pd_at = [(-pw, 0), (-3, -1), (2, -2), (-2, -2)]
    penc = _ArithEncoder()
    penc.encode_generic(np.hstack(patterns), at=pd_at)
    pd_payload = (bytes([0, pw, ph]) + struct.pack(">I", n - 1)
                  + penc.flush())

    # ---- halftone region: default grid = pattern-sized cells. The
    # 6.6.5.2 walk gives x = HGX+n*HRX, y = HGY+m*HRX when HRY=0, so
    # one vector sets BOTH strides — square patterns tile exactly
    # (the common scanner case); pass hrx/hry for skewed grids.
    if hrx is None:
        if ph != pw:
            raise JBIG2Error("default grid needs square patterns")
        hrx = pw << 8                                # 8.8 fixed point
        hry = 0
    bits = max(1, (n - 1).bit_length())
    planes = []
    for j in range(bits - 1, -1, -1):                # MSB first
        b = (gray >> j) & 1
        b_next = (gray >> (j + 1)) & 1               # 0 for the MSB
        planes.append((b ^ b_next).astype(np.uint8))  # gray code
    ht_at = [(3, -1), (-3, -1), (2, -2), (-2, -2)]
    henc = _ArithEncoder()
    for plane in planes:
        henc.encode_generic(plane, at=ht_at)
    region_info = struct.pack(">IIII", page_w, page_h, 0, 0) + b"\x00"
    ht_payload = (region_info + bytes([0])
                  + struct.pack(">II", hgw, hgh)
                  + struct.pack(">ii", hgx << 8, hgy << 8)
                  + struct.pack(">HH", hrx, hry)
                  + henc.flush())

    page_info = (struct.pack(">IIII", page_w, page_h, 0, 0)
                 + b"\x01" + b"\x00\x00")
    return (_segment(0, 48, 1, page_info)
            + _segment(1, 16, 1, pd_payload)
            + _segment(2, 23, 1, ht_payload, refs=(1,))
            + _segment(3, 49, 1, b""))


def _segment(num: int, stype: int, page: int, payload: bytes,
             refs: Tuple[int, ...] = ()) -> bytes:
    if len(refs) > 4:
        raise JBIG2Error("fixture encoder supports <= 4 referred segments")
    rts = bytes([len(refs) << 5]) + bytes(refs)      # short form, 1B refs
    return (struct.pack(">IB", num, stype) + rts
            + bytes([page]) + struct.pack(">I", len(payload)) + payload)


def encode_embedded(bitmap: np.ndarray, *, template: int = 0,
                    tpgdon: bool = False,
                    mmr_data: Optional[bytes] = None,
                    op: int = 0) -> bytes:
    """Wrap a bitmap as a PDF-embeddable JBIG2 stream: page info +
    one immediate lossless generic region + end-of-page. Pass
    ``mmr_data`` (externally G4/T.6-coded, e.g. via Pillow in tests)
    to emit an MMR region instead of MQ coding ``bitmap``."""
    bitmap = np.asarray(bitmap, np.uint8)
    h, w = bitmap.shape
    page_info = struct.pack(">IIII", w, h, 0, 0) + b"\x01" + b"\x00\x00"
    region_info = struct.pack(">IIII", w, h, 0, 0) + bytes([op & 7])
    if mmr_data is not None:
        body = bytes([1]) + mmr_data
    else:
        gflags = (template << 1) | (8 if tpgdon else 0)
        at = b"".join(struct.pack(">bb", ax, ay)
                      for ax, ay in _NOMINAL_AT[template])
        body = bytes([gflags]) + at + encode_generic(
            bitmap, template=template, tpgdon=tpgdon)
    return (_segment(0, 48, 1, page_info)
            + _segment(1, 39, 1, region_info + body)
            + _segment(2, 49, 1, b""))
