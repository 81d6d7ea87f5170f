"""CCITT Group 3/4 fax decoding (ITU-T T.4/T.6) — pure stdlib.

Copy of `rag_application_tpu/ingest/ccitt.py`.

Scanned PDFs overwhelmingly store their raster as CCITTFaxDecode image
XObjects. The reference rasterizes whole pages with pdf2image/poppler
(IndexerAPI/src/core/processors/utils.py:16-22); the native pipeline
instead recovers the embedded image itself (ingest/pdf.py), and this
module decodes the fax codec so those pages reach the VLM hook without
any external renderer — previously they required the `pdf_rasterizer`
override (VERDICT r2, ingest long-tail).

Supported: K < 0 (pure 2D / Group 4 — what PDF writers emit almost
exclusively), K = 0 (1D MH / Group 3), EncodedByteAlign, EOL tolerance,
EOFB/RTC termination. Returns a packed 1-bit-per-pixel bitmap with
**1 = black ink** (the caller maps ink onto its output colorspace).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["CCITTError", "decode_ccitt"]


class CCITTError(ValueError):
    pass


# ---------------------------------------------------------------- tables
# ITU-T T.4 modified-Huffman run-length codes, written as bit-strings
# (MSB first). Terminating codes 0-63, makeup codes 64-1728, and the
# shared extended makeup codes 1792-2560.

_WHITE_CODES: Dict[str, int] = {
    "00110101": 0, "000111": 1, "0111": 2, "1000": 3, "1011": 4,
    "1100": 5, "1110": 6, "1111": 7, "10011": 8, "10100": 9,
    "00111": 10, "01000": 11, "001000": 12, "000011": 13, "110100": 14,
    "110101": 15, "101010": 16, "101011": 17, "0100111": 18,
    "0001100": 19, "0001000": 20, "0010111": 21, "0000011": 22,
    "0000100": 23, "0101000": 24, "0101011": 25, "0010011": 26,
    "0100100": 27, "0011000": 28, "00000010": 29, "00000011": 30,
    "00011010": 31, "00011011": 32, "00010010": 33, "00010011": 34,
    "00010100": 35, "00010101": 36, "00010110": 37, "00010111": 38,
    "00101000": 39, "00101001": 40, "00101010": 41, "00101011": 42,
    "00101100": 43, "00101101": 44, "00000100": 45, "00000101": 46,
    "00001010": 47, "00001011": 48, "01010010": 49, "01010011": 50,
    "01010100": 51, "01010101": 52, "00100100": 53, "00100101": 54,
    "01011000": 55, "01011001": 56, "01011010": 57, "01011011": 58,
    "01001010": 59, "01001011": 60, "00110010": 61, "00110011": 62,
    "00110100": 63,
    # makeup
    "11011": 64, "10010": 128, "010111": 192, "0110111": 256,
    "00110110": 320, "00110111": 384, "01100100": 448, "01100101": 512,
    "01101000": 576, "01100111": 640, "011001100": 704,
    "011001101": 768, "011010010": 832, "011010011": 896,
    "011010100": 960, "011010101": 1024, "011010110": 1088,
    "011010111": 1152, "011011000": 1216, "011011001": 1280,
    "011011010": 1344, "011011011": 1408, "010011000": 1472,
    "010011001": 1536, "010011010": 1600, "011000": 1664,
    "010011011": 1728,
}

_BLACK_CODES: Dict[str, int] = {
    "0000110111": 0, "010": 1, "11": 2, "10": 3, "011": 4, "0011": 5,
    "0010": 6, "00011": 7, "000101": 8, "000100": 9, "0000100": 10,
    "0000101": 11, "0000111": 12, "00000100": 13, "00000111": 14,
    "000011000": 15, "0000010111": 16, "0000011000": 17,
    "0000001000": 18, "00001100111": 19, "00001101000": 20,
    "00001101100": 21, "00000110111": 22, "00000101000": 23,
    "00000010111": 24, "00000011000": 25, "000011001010": 26,
    "000011001011": 27, "000011001100": 28, "000011001101": 29,
    "000001101000": 30, "000001101001": 31, "000001101010": 32,
    "000001101011": 33, "000011010010": 34, "000011010011": 35,
    "000011010100": 36, "000011010101": 37, "000011010110": 38,
    "000011010111": 39, "000001101100": 40, "000001101101": 41,
    "000011011010": 42, "000011011011": 43, "000001010100": 44,
    "000001010101": 45, "000001010110": 46, "000001010111": 47,
    "000001100100": 48, "000001100101": 49, "000001010010": 50,
    "000001010011": 51, "000000100100": 52, "000000110111": 53,
    "000000111000": 54, "000000100111": 55, "000000101000": 56,
    "000001011000": 57, "000001011001": 58, "000000101011": 59,
    "000000101100": 60, "000001011010": 61, "000001100110": 62,
    "000001100111": 63,
    # makeup
    "0000001111": 64, "000011001000": 128, "000011001001": 192,
    "000001011011": 256, "000000110011": 320, "000000110100": 384,
    "000000110101": 448, "0000001101100": 512, "0000001101101": 576,
    "0000001001010": 640, "0000001001011": 704, "0000001001100": 768,
    "0000001001101": 832, "0000001110010": 896, "0000001110011": 960,
    "0000001110100": 1024, "0000001110101": 1088, "0000001110110": 1152,
    "0000001110111": 1216, "0000001010010": 1280, "0000001010011": 1344,
    "0000001010100": 1408, "0000001010101": 1472, "0000001011010": 1536,
    "0000001011011": 1600, "0000001100100": 1664, "0000001100101": 1728,
}

_EXT_MAKEUP: Dict[str, int] = {
    "00000001000": 1792, "00000001100": 1856, "00000001101": 1920,
    "000000010010": 1984, "000000010011": 2048, "000000010100": 2112,
    "000000010101": 2176, "000000010110": 2240, "000000010111": 2304,
    "000000011100": 2368, "000000011101": 2432, "000000011110": 2496,
    "000000011111": 2560,
}

_WHITE = {**_WHITE_CODES, **_EXT_MAKEUP}
_BLACK = {**_BLACK_CODES, **_EXT_MAKEUP}
_MAX_CODE_LEN = 14
_EOL = "000000000001"


class _Bits:
    __slots__ = ("bits", "pos")

    def __init__(self, data: bytes):
        self.bits = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def exhausted(self, slack: int = 0) -> bool:
        return self.pos + slack >= len(self.bits)

    def peek(self, n: int) -> str:
        return self.bits[self.pos:self.pos + n]

    def skip(self, n: int) -> None:
        self.pos += n

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) // 8 * 8

    def try_eat(self, code: str) -> bool:
        if self.bits.startswith(code, self.pos):
            self.pos += len(code)
            return True
        return False


def _read_run(bits: _Bits, table: Dict[str, int]) -> int:
    """One complete run length: makeup codes (>=64) chain until a
    terminating code (<64) arrives."""
    total = 0
    while True:
        run = None
        for ln in range(2, _MAX_CODE_LEN + 1):
            run = table.get(bits.peek(ln))
            if run is not None:
                bits.skip(ln)
                break
        if run is None:
            raise CCITTError(f"bad run code at bit {bits.pos}")
        total += run
        if run < 64:
            return total


def _row_to_transitions(row: List[int]) -> List[int]:
    """Run lengths (starting white) -> changing-element positions."""
    out, pos = [], 0
    for r in row:
        pos += r
        out.append(pos)
    return out


def decode_ccitt(data: bytes, columns: int, rows: int = 0, *, k: int = -1,
                 byte_align: bool = False,
                 max_rows: int = 1 << 16) -> Tuple[bytes, int]:
    """Decode to (packed bitmap, n_rows); bit 1 = black ink, rows padded
    to whole bytes. `rows` = 0 decodes until EOFB/exhaustion."""
    if columns <= 0:
        raise CCITTError("columns must be positive")
    bits = _Bits(data)
    out = bytearray()
    row_bytes = (columns + 7) // 8
    # reference line: changing elements of the previous row; an all-white
    # imaginary line above the first row
    ref: List[int] = [columns, columns]
    n_rows = 0
    limit = rows if rows > 0 else max_rows

    while n_rows < limit:
        if byte_align:
            bits.byte_align()
        # tolerate EOL markers (G3) / detect EOFB (G4: two EOLs)
        saw_eol = False
        while bits.try_eat(_EOL):
            saw_eol = True
            if bits.try_eat(_EOL):
                return bytes(out), n_rows
            if k < 0:
                return bytes(out), n_rows  # single EOL ends a G4 block
            bits.try_eat("1") or bits.try_eat("0")  # G3-2D tag bit (K>0)
        if bits.exhausted(slack=_MAX_CODE_LEN - 1) and not saw_eol:
            break

        cur: List[int] = []  # changing-element positions of this row
        a0 = -1
        color = 0  # 0 = white, 1 = black
        try:
            if k == 0:
                # 1D row: alternating MH runs starting white
                pos = 0
                while pos < columns:
                    run = _read_run(bits, _BLACK if color else _WHITE)
                    pos = min(pos + run, columns)
                    cur.append(pos)
                    color ^= 1
            else:
                # 2D (G4) row
                while a0 < columns:
                    # b1: first ref change > a0 with color opposite the
                    # current color (ref alternates starting black)
                    i = 0
                    while i < len(ref) and (ref[i] <= a0 or i % 2 != color):
                        i += 1
                    b1 = ref[i] if i < len(ref) else columns
                    b2 = ref[i + 1] if i + 1 < len(ref) else columns
                    if bits.try_eat("0001"):          # pass
                        cur_pos = b2
                        a0 = cur_pos  # color unchanged, no transition
                        continue
                    if bits.try_eat("001"):           # horizontal
                        base = 0 if a0 < 0 else a0
                        r1 = _read_run(bits, _BLACK if color else _WHITE)
                        r2 = _read_run(bits, _WHITE if color else _BLACK)
                        a1 = min(base + r1, columns)
                        a2 = min(a1 + r2, columns)
                        cur.append(a1)
                        cur.append(a2)
                        a0 = a2
                        continue
                    # vertical modes
                    delta = None
                    for code, d in (("1", 0), ("011", 1), ("010", -1),
                                    ("000011", 2), ("000010", -2),
                                    ("0000011", 3), ("0000010", -3)):
                        if bits.try_eat(code):
                            delta = d
                            break
                    if delta is None:
                        if saw_eol or bits.exhausted():
                            raise CCITTError("truncated")
                        raise CCITTError(
                            f"bad 2D mode code at bit {bits.pos}")
                    a1 = max(0, min(b1 + delta, columns))
                    cur.append(a1)
                    a0 = a1
                    color ^= 1
        except CCITTError:
            if n_rows:  # salvage what decoded (truncated streams exist)
                break
            raise

        # render the row: transitions alternate white->black->white...
        rowbuf = bytearray(row_bytes)
        pos, ink = 0, 0
        for t in cur + [columns]:
            t = min(t, columns)
            if ink:
                for p in range(pos, t):
                    rowbuf[p >> 3] |= 0x80 >> (p & 7)
            pos = t
            ink ^= 1
            if pos >= columns:
                break
        out.extend(rowbuf)
        n_rows += 1
        ref = (cur + [columns, columns]) if cur else [columns, columns]

    return bytes(out), n_rows


def decode_ccitt_params(data: bytes, parms: dict,
                        width: int, height: int) -> Optional[bytes]:
    """PDF DecodeParms adapter: returns 1-bpc gray samples (0 = black
    ink — the PNG wrap's convention) or None when unsupported."""
    k = int(parms.get("K", 0) or 0)
    if k > 0:
        return None  # mixed G3-2D: not worth the complexity until seen
    columns = int(parms.get("Columns", 1728) or 1728)
    if width and columns != width:
        columns = width or columns
    try:
        bitmap, n = decode_ccitt(
            data, columns, rows=height or 0, k=k,
            byte_align=bool(parms.get("EncodedByteAlign")))
    except CCITTError:
        return None
    if n == 0:
        return None
    row_bytes = (columns + 7) // 8
    if height and n < height:
        bitmap = bitmap + b"\x00" * ((height - n) * row_bytes)
    # ink=1 -> sample 0 (black in 1-bpc gray)
    return bytes(b ^ 0xFF for b in bitmap)
