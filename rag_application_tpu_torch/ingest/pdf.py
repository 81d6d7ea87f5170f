"""Pure-Python PDF page splitting + text extraction (stdlib only).

Copy of `rag_application_tpu/ingest/pdf.py`.

The reference's headline ingest flow splits PDFs per page with pypdf and
extracts page content via markitdown/pdfminer and a VLM
(IndexerAPI/src/core/processors/file_processor.py:150-184,
utils.py:16-22, _unstructured_processor.py:40-44). This module is the
native equivalent: it parses the PDF object graph itself — classic xref
tables AND cross-reference/object streams, FlateDecode (zlib) / LZW /
ASCIIHex / ASCII85 / RunLength filters with PNG predictors — walks the
page tree, and decodes each page's content streams into text using the
fonts' ToUnicode CMaps and encoding /Differences.

Covers the overwhelming majority of real-world digital PDFs, including
documents encrypted with the standard security handler under an empty
user/owner password (RC4, AES-128 and AES-256 — pdf_crypt.py), which is
how pypdf serves the reference transparently. What it deliberately does
not do: render glyphs (scanned/image-only pages yield no text and are
routed to the VLM hook by the pipeline) and decrypt password-protected
documents (raises PDFError, which the pipeline turns into a
NonRetryableError).
"""

from __future__ import annotations

import re
import zlib
from typing import Any, Dict, List, Optional, Tuple, Union


class PDFError(ValueError):
    """Unparseable or unsupported PDF (surfaces as NonRetryableError)."""


class Ref(tuple):
    """Indirect object reference `num gen R`."""

    __slots__ = ()

    def __new__(cls, num: int, gen: int):
        return super().__new__(cls, (num, gen))

    @property
    def num(self) -> int:
        return self[0]


class Name(str):
    """A PDF name token (`/Foo`), distinct from string values."""

    __slots__ = ()


class Keyword(bytes):
    """A bare keyword token (obj, stream, R, Tj, ...) — distinct from
    string values, which are plain bytes."""

    __slots__ = ()


class Stream:
    def __init__(self, d: Dict[str, Any], raw: bytes, doc: "PDFDocument",
                 num: int = 0, gen: int = 0):
        self.dict = d
        self.raw = raw
        self.num = num
        self.gen = gen
        self._doc = doc
        self._data: Optional[bytes] = None

    def data(self) -> bytes:
        if self._data is None:
            raw = self.raw
            doc = self._doc
            if doc.crypt is not None and self.num:
                # cross-reference streams are never encrypted; neither
                # is /Metadata when EncryptMetadata is false
                typ = str(doc.resolve(self.dict.get("Type", "")) or "")
                if typ != "XRef" and not (
                        typ == "Metadata" and
                        not doc.crypt.encrypt_metadata):
                    raw = doc.crypt.decrypt_stream(raw, self.num, self.gen)
            self._data = _decode_stream(self.dict, raw, doc)
        return self._data


_WHITESPACE = b"\x00\t\n\x0c\r "
_DELIMS = b"()<>[]{}/%"


class Lexer:
    """Tokenizer over the PDF byte syntax (also used for content
    streams, whose operator keywords come back as plain `bytes`)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _skip_ws(self) -> None:
        d, n = self.data, len(self.data)
        while self.pos < n:
            c = d[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # '%' comment to EOL
                while self.pos < n and d[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                return

    def next(self):
        """Return the next token: int/float, Name, bytes (string),
        one of the markers '[' ']' '<<' '>>' '{' '}', a keyword bytes
        like b'obj', or None at end."""
        self._skip_ws()
        d, n = self.data, len(self.data)
        if self.pos >= n:
            return None
        c = d[self.pos]
        if c == 0x2F:  # '/'
            return self._name()
        if c == 0x28:  # '('
            return self._literal_string()
        if c == 0x3C:  # '<'
            if self.pos + 1 < n and d[self.pos + 1] == 0x3C:
                self.pos += 2
                return "<<"
            return self._hex_string()
        if c == 0x3E:  # '>'
            if self.pos + 1 < n and d[self.pos + 1] == 0x3E:
                self.pos += 2
                return ">>"
            self.pos += 1
            return ">"
        if c in b"[]{}":
            self.pos += 1
            return chr(c)
        if c == 0x29:  # stray ')'
            self.pos += 1
            return ")"
        # number or keyword
        start = self.pos
        while self.pos < n and d[self.pos] not in _WHITESPACE and \
                d[self.pos] not in _DELIMS:
            self.pos += 1
        tok = d[start:self.pos]
        if not tok:  # defensive: lone delimiter already handled
            self.pos += 1
            return chr(c)
        if re.fullmatch(rb"[+-]?\d+", tok):
            return int(tok)
        if re.fullmatch(rb"[+-]?(\d*\.\d*|\d+)", tok):
            try:
                return float(tok)
            except ValueError:
                return 0.0
        # keyword: obj/endobj/stream/R/true/false/null/BT/Tj/...
        return Keyword(tok)

    def _name(self) -> Name:
        d, n = self.data, len(self.data)
        self.pos += 1
        out = bytearray()
        while self.pos < n:
            c = d[self.pos]
            if c in _WHITESPACE or c in _DELIMS:
                break
            if c == 0x23 and self.pos + 2 < n:  # '#xx'
                try:
                    out.append(int(d[self.pos + 1:self.pos + 3], 16))
                    self.pos += 3
                    continue
                except ValueError:
                    pass
            out.append(c)
            self.pos += 1
        return Name(out.decode("latin-1"))

    def _literal_string(self) -> bytes:
        d, n = self.data, len(self.data)
        self.pos += 1
        out = bytearray()
        depth = 1
        while self.pos < n:
            c = d[self.pos]
            if c == 0x5C:  # backslash
                self.pos += 1
                if self.pos >= n:
                    break
                e = d[self.pos]
                if e in b"nrtbf":
                    out.append({0x6E: 10, 0x72: 13, 0x74: 9,
                                0x62: 8, 0x66: 12}[e])
                    self.pos += 1
                elif e in b"()\\":
                    out.append(e)
                    self.pos += 1
                elif e in b"\r\n":  # line continuation
                    self.pos += 1
                    if e == 0x0D and self.pos < n and d[self.pos] == 0x0A:
                        self.pos += 1
                elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                    val = 0
                    for _ in range(3):
                        if self.pos < n and 0x30 <= d[self.pos] <= 0x37:
                            val = val * 8 + (d[self.pos] - 0x30)
                            self.pos += 1
                        else:
                            break
                    out.append(val & 0xFF)
                else:
                    out.append(e)
                    self.pos += 1
            elif c == 0x28:
                depth += 1
                out.append(c)
                self.pos += 1
            elif c == 0x29:
                depth -= 1
                self.pos += 1
                if depth == 0:
                    break
                out.append(c)
            else:
                out.append(c)
                self.pos += 1
        return bytes(out)

    def _hex_string(self) -> bytes:
        d, n = self.data, len(self.data)
        self.pos += 1
        hexs = bytearray()
        while self.pos < n and d[self.pos] != 0x3E:
            c = d[self.pos]
            if c not in _WHITESPACE:
                hexs.append(c)
            self.pos += 1
        self.pos += 1  # consume '>'
        if len(hexs) % 2:
            hexs.append(0x30)
        try:
            return bytes.fromhex(hexs.decode("ascii"))
        except ValueError:
            return b""


def _parse_value(lex: Lexer, tok=None):
    """Parse one object value starting at `tok` (or the next token).
    `N G R` references are folded into Ref by lookahead."""
    if tok is None:
        tok = lex.next()
    if tok is None:
        raise PDFError("unexpected end of data")
    if tok == "<<":
        d: Dict[str, Any] = {}
        while True:
            k = lex.next()
            if k == ">>" or k is None:
                return d
            if not isinstance(k, Name):
                # skip malformed key
                continue
            d[str(k)] = _parse_value(lex)
    if tok == "[":
        arr: List[Any] = []
        while True:
            save = lex.pos
            t = lex.next()
            if t == "]" or t is None:
                return arr
            lex.pos = save
            arr.append(_parse_value(lex))
    if isinstance(tok, int):
        # possible `N G R`
        save = lex.pos
        t2 = lex.next()
        if isinstance(t2, int):
            t3 = lex.next()
            if isinstance(t3, Keyword) and t3 == b"R":
                return Ref(tok, t2)
        lex.pos = save
        return tok
    if isinstance(tok, Keyword):
        if tok == b"true":
            return True
        if tok == b"false":
            return False
        if tok == b"null":
            return None
    return tok  # Name, bytes string, float, or keyword


# ----------------------------------------------------------------- filters

def _png_predictor(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    bpp = max(1, (colors * bpc) // 8)
    row_len = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(row_len)
    pos = 0
    while pos + 1 + row_len <= len(data) or (pos < len(data) and
                                             len(data) - pos - 1 > 0):
        ft = data[pos]
        row = bytearray(data[pos + 1:pos + 1 + row_len])
        if len(row) < row_len:
            row.extend(b"\x00" * (row_len - len(row)))
        pos += 1 + row_len
        if ft == 1:  # Sub
            for i in range(bpp, row_len):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:  # Up
            for i in range(row_len):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:  # Average
            for i in range(row_len):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(row_len):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out.extend(row)
        prev = row
        if pos >= len(data):
            break
    return bytes(out)


def _tiff_predictor(data: bytes, colors: int, bpc: int, columns: int) -> bytes:
    if bpc != 8:
        return data
    row_len = columns * colors
    out = bytearray(data)
    for r in range(0, len(out) - row_len + 1, row_len):
        for i in range(colors, row_len):
            out[r + i] = (out[r + i] + out[r + i - colors]) & 0xFF
    return bytes(out)


def _lzw_decode(data: bytes, early: int = 1) -> bytes:
    """PDF-flavored LZW (9->12 bit codes, 256=clear, 257=EOD)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    bits, buf, nbits = 0, 0, 9
    prev: Optional[bytes] = None
    for byte in data:
        buf = (buf << 8) | byte
        bits += 8
        while bits >= nbits:
            bits -= nbits
            code = (buf >> bits) & ((1 << nbits) - 1)
            if code == 256:
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                nbits = 9
                prev = None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out.extend(entry)
            prev = entry
            if len(table) + early - 1 >= (1 << nbits) and nbits < 12:
                nbits += 1
    return bytes(out)


def _a85_decode(data: bytes) -> bytes:
    import base64

    data = data.replace(b"<~", b"").replace(b"~>", b"")
    data = bytes(c for c in data if c not in _WHITESPACE)
    try:
        return base64.a85decode(data)
    except ValueError as e:
        raise PDFError(f"bad ASCII85 data: {e}") from e


def _rl_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        l = data[i]
        if l == 128:
            break
        if l < 128:
            out.extend(data[i + 1:i + 2 + l])
            i += 2 + l
        else:
            out.extend(data[i + 1:i + 2] * (257 - l))
            i += 2
    return bytes(out)


def _decode_stream(d: Dict[str, Any], raw: bytes, doc: "PDFDocument") -> bytes:
    filters = doc.resolve(d.get("Filter"))
    if filters is None:
        return raw
    if not isinstance(filters, list):
        filters = [filters]
    parms = doc.resolve(d.get("DecodeParms") or d.get("DP"))
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    elif len(parms) < len(filters):
        # malformed files ship short DecodeParms lists; zip() would
        # silently drop the trailing filters and return half-decoded
        # bytes — pad instead
        parms = list(parms) + [None] * (len(filters) - len(parms))
    data = raw
    for f, p in zip(filters, parms):
        f = str(doc.resolve(f) or "")
        p = doc.resolve(p) or {}
        if f in ("FlateDecode", "Fl"):
            try:
                data = zlib.decompress(data)
            except zlib.error:
                try:  # tolerate truncated streams
                    data = zlib.decompressobj().decompress(data)
                except zlib.error as e:
                    raise PDFError(f"bad Flate stream: {e}") from e
        elif f in ("LZWDecode", "LZW"):
            data = _lzw_decode(data, int(doc.resolve(p.get("EarlyChange", 1))))
        elif f in ("ASCIIHexDecode", "AHx"):
            h = bytes(c for c in data if c not in _WHITESPACE and c != 0x3E)
            if len(h) % 2:
                h += b"0"
            data = bytes.fromhex(h.decode("ascii", "ignore"))
        elif f in ("ASCII85Decode", "A85"):
            data = _a85_decode(data)
        elif f in ("RunLengthDecode", "RL"):
            data = _rl_decode(data)
        elif f == "Crypt":
            if str(doc.resolve(p.get("Name", "Identity"))) != "Identity":
                raise PDFError("non-default Crypt filter unsupported")
            # Identity = already handled by document-level decryption
        else:
            # image codecs (DCTDecode/JPXDecode/CCITT/JBIG2) stay raw —
            # they carry no extractable text
            return data
        pred = int(doc.resolve(p.get("Predictor", 1)) or 1)
        if pred >= 10:
            data = _png_predictor(
                data, int(doc.resolve(p.get("Colors", 1)) or 1),
                int(doc.resolve(p.get("BitsPerComponent", 8)) or 8),
                int(doc.resolve(p.get("Columns", 1)) or 1))
        elif pred == 2:
            data = _tiff_predictor(
                data, int(doc.resolve(p.get("Colors", 1)) or 1),
                int(doc.resolve(p.get("BitsPerComponent", 8)) or 8),
                int(doc.resolve(p.get("Columns", 1)) or 1))
    return data


# ---------------------------------------------------------------- document

class PDFDocument:
    def __init__(self, data: bytes):
        if not data.lstrip()[:5].startswith(b"%PDF-"):
            raise PDFError("not a PDF (missing %PDF- header)")
        self.data = data
        # objnum -> ("off", byte_offset) | ("objstm", container_num, idx)
        self.xref: Dict[int, Tuple[str, int, int]] = {}
        self.trailer: Dict[str, Any] = {}
        self._cache: Dict[int, Any] = {}
        self._objstm_cache: Dict[int, List[Tuple[int, Any]]] = {}
        self.crypt = None  # StandardSecurityHandler once authenticated
        self._encrypt_num = -1
        try:
            self._load_xref()
        except Exception:
            # fall through to the recovery scan below
            pass
        if not self.xref or "Root" not in self.trailer:
            self._scan_objects()
        enc_ref = self.trailer.get("Encrypt")
        if enc_ref is not None:
            self._setup_crypt(enc_ref)

    def _setup_crypt(self, enc_ref: Any) -> None:
        """Authenticate the empty password against the standard security
        handler (pdf_crypt.py) — parity with pypdf's transparent decrypt
        of permissions-only encrypted files, which the reference relies
        on (IndexerAPI/src/core/processors/file_processor.py:150-184)."""
        from .pdf_crypt import PDFCryptError, StandardSecurityHandler

        if isinstance(enc_ref, Ref):
            self._encrypt_num = enc_ref.num
        enc = self.resolve(enc_ref)
        if not isinstance(enc, dict):
            raise PDFError("malformed /Encrypt dictionary")
        ids = self.resolve(self.trailer.get("ID"))
        id0 = b""
        if isinstance(ids, list) and ids:
            v = self.resolve(ids[0])
            if isinstance(v, bytes):
                id0 = v
        enc = {k: self.resolve(v) for k, v in enc.items()}
        cf = enc.get("CF")
        if isinstance(cf, dict):
            enc["CF"] = {k: self.resolve(v) for k, v in cf.items()}
        try:
            self.crypt = StandardSecurityHandler(enc, id0)
        except PDFCryptError as e:
            raise PDFError(f"encrypted PDF: {e}") from e
        # drop anything cached before authentication (e.g. the recovery
        # scan's catalog hunt) so it re-reads decrypted
        self._cache.clear()
        self._objstm_cache.clear()

    def _decrypt_value(self, val: Any, num: int, gen: int) -> Any:
        """Recursively decrypt literal/hex strings in a parsed object
        (streams keep their raw bytes — Stream.data() decrypts lazily,
        but their dictionaries are walked here)."""
        if isinstance(val, Keyword):
            return val
        if isinstance(val, bytes):
            return self.crypt.decrypt_string(val, num, gen)
        if isinstance(val, list):
            return [self._decrypt_value(v, num, gen) for v in val]
        if isinstance(val, dict):
            return {k: self._decrypt_value(v, num, gen)
                    for k, v in val.items()}
        if isinstance(val, Stream):
            val.dict = self._decrypt_value(val.dict, num, gen)
            return val
        return val

    # -- xref chain ------------------------------------------------------

    def _load_xref(self) -> None:
        tail = self.data[-2048:]
        m = None
        for m in re.finditer(rb"startxref\s+(\d+)", tail):
            pass
        if m is None:
            raise PDFError("no startxref")
        offset = int(m.group(1))
        seen = set()
        while offset and offset not in seen and offset < len(self.data):
            seen.add(offset)
            offset = self._load_xref_section(offset)

    def _load_xref_section(self, offset: int) -> int:
        lex = Lexer(self.data, offset)
        save = lex.pos
        tok = lex.next()
        if tok == b"xref":
            return self._load_xref_table(lex)
        lex.pos = save
        # xref stream: `N G obj <<...>> stream`
        num, stream = self._parse_indirect_at(offset)
        if not isinstance(stream, Stream):
            raise PDFError("startxref points at a non-stream object")
        return self._load_xref_stream(stream)

    def _load_xref_table(self, lex: Lexer) -> int:
        while True:
            save = lex.pos
            tok = lex.next()
            if tok == b"trailer":
                t = lex.next()
                if t != "<<":
                    raise PDFError("malformed trailer")
                trailer = _parse_value(lex, "<<")
                for k, v in trailer.items():
                    self.trailer.setdefault(k, v)
                # hybrid files: /XRefStm points to an xref stream with
                # entries for compressed objects
                if "XRefStm" in trailer:
                    try:
                        _, s = self._parse_indirect_at(int(trailer["XRefStm"]))
                        if isinstance(s, Stream):
                            self._load_xref_stream(s)
                    except Exception:
                        pass
                return int(trailer.get("Prev", 0) or 0)
            if not isinstance(tok, int):
                raise PDFError("malformed xref table")
            start = tok
            count = lex.next()
            if not isinstance(count, int):
                raise PDFError("malformed xref subsection")
            lex._skip_ws()
            for i in range(count):
                line = self.data[lex.pos:lex.pos + 20]
                mm = re.match(rb"(\d{10})\s+(\d{5})\s+([nf])", line)
                if not mm:
                    raise PDFError("malformed xref entry")
                lex.pos += mm.end()
                lex._skip_ws()
                if mm.group(3) == b"n" and (start + i) not in self.xref:
                    self.xref[start + i] = ("off", int(mm.group(1)), 0)
            _ = save

    def _load_xref_stream(self, stream: Stream) -> int:
        d = stream.dict
        w = [int(self.resolve(x)) for x in self.resolve(d.get("W", []))]
        if len(w) < 3:
            raise PDFError("xref stream missing /W")
        size = int(self.resolve(d.get("Size", 0)))
        index = self.resolve(d.get("Index")) or [0, size]
        data = stream.data()
        entry_len = sum(w)
        pos = 0

        def field(b: bytes, start: int, width: int, default: int) -> int:
            if width == 0:
                return default
            return int.from_bytes(b[start:start + width], "big")

        for i in range(0, len(index) - 1, 2):
            first, count = int(self.resolve(index[i])), int(
                self.resolve(index[i + 1]))
            for j in range(count):
                if pos + entry_len > len(data):
                    break
                e = data[pos:pos + entry_len]
                pos += entry_len
                typ = field(e, 0, w[0], 1)
                f2 = field(e, w[0], w[1], 0)
                f3 = field(e, w[0] + w[1], w[2], 0)
                num = first + j
                if num in self.xref:
                    continue
                if typ == 1:
                    self.xref[num] = ("off", f2, f3)
                elif typ == 2:
                    self.xref[num] = ("objstm", f2, f3)
        for k, v in d.items():
            if k not in ("W", "Index", "Filter", "DecodeParms", "Length",
                         "Type"):
                self.trailer.setdefault(k, v)
        return int(self.resolve(d.get("Prev", 0)) or 0)

    def _scan_objects(self) -> None:
        """Recovery path: index every `N G obj` in the raw bytes (last
        occurrence of an object number wins, matching incremental-update
        semantics) and find a /Root."""
        for m in re.finditer(rb"(?<![0-9])(\d+)\s+(\d+)\s+obj\b", self.data):
            self.xref[int(m.group(1))] = ("off", m.start(), 0)
        if "Root" not in self.trailer:
            for m in re.finditer(rb"/Root\s+(\d+)\s+(\d+)\s+R", self.data):
                self.trailer["Root"] = Ref(int(m.group(1)), int(m.group(2)))
        if "Root" not in self.trailer:
            # last resort: any object with /Type /Catalog
            for num in list(self.xref):
                try:
                    obj = self.get(num)
                except Exception:
                    continue
                if isinstance(obj, dict) and \
                        str(obj.get("Type", "")) == "Catalog":
                    self.trailer["Root"] = Ref(num, 0)
                    break
        if "Root" not in self.trailer:
            raise PDFError("no document catalog found")

    # -- object access ---------------------------------------------------

    def _parse_indirect_at(self, offset: int) -> Tuple[int, Any]:
        lex = Lexer(self.data, offset)
        num = lex.next()
        gen = lex.next()
        kw = lex.next()
        if not isinstance(num, int) or kw != b"obj":
            raise PDFError(f"no indirect object at offset {offset}")
        if not isinstance(gen, int):
            gen = 0
        val = _parse_value(lex)
        save = lex.pos
        tok = lex.next()
        if tok == b"stream":
            if not isinstance(val, dict):
                raise PDFError("stream without a dictionary")
            # EOL after `stream` is CRLF or LF
            p = lex.pos
            if self.data[p:p + 2] == b"\r\n":
                p += 2
            elif self.data[p:p + 1] in (b"\n", b"\r"):
                p += 1
            length = self.resolve(val.get("Length"))
            raw = None
            if isinstance(length, int) and 0 <= length <= len(self.data) - p:
                raw = self.data[p:p + length]
                # sanity: endstream should follow (possibly after EOL)
                trail = self.data[p + length:p + length + 20]
                if b"endstream" not in trail:
                    raw = None
            if raw is None:
                end = self.data.find(b"endstream", p)
                if end < 0:
                    raise PDFError("unterminated stream")
                raw = self.data[p:end].rstrip(b"\r\n")
            return num, Stream(val, raw, self, num, gen)
        lex.pos = save
        return num, val

    def get(self, ref: Union[Ref, int]) -> Any:
        num = ref.num if isinstance(ref, Ref) else int(ref)
        if num in self._cache:
            return self._cache[num]
        entry = self.xref.get(num)
        if entry is None:
            return None
        self._cache[num] = None  # cycle guard
        if entry[0] == "off":
            try:
                got_num, val = self._parse_indirect_at(entry[1])
            except PDFError:
                val = None
            else:
                if got_num != num:
                    val = None
            # strings inside directly-stored objects are encrypted with
            # the object's own (num, gen) key; objects INSIDE object
            # streams are not separately encrypted (the container was)
            if val is not None and self.crypt is not None and \
                    num != self._encrypt_num:
                gen = val.gen if isinstance(val, Stream) else 0
                val = self._decrypt_value(val, num, gen)
        else:  # in an object stream
            val = self._get_from_objstm(entry[1], entry[2], num)
        self._cache[num] = val
        return val

    def _get_from_objstm(self, container: int, idx: int,
                         want: int) -> Any:
        objs = self._objstm_cache.get(container)
        if objs is None:
            stm = self.get(container)
            if not isinstance(stm, Stream):
                return None
            data = stm.data()
            n = int(self.resolve(stm.dict.get("N", 0)))
            first = int(self.resolve(stm.dict.get("First", 0)))
            head = Lexer(data[:first])
            pairs = []
            for _ in range(n):
                onum = head.next()
                ooff = head.next()
                if not isinstance(onum, int) or not isinstance(ooff, int):
                    break
                pairs.append((onum, ooff))
            objs = []
            for onum, ooff in pairs:
                lex = Lexer(data, first + ooff)
                try:
                    objs.append((onum, _parse_value(lex)))
                except PDFError:
                    objs.append((onum, None))
            self._objstm_cache[container] = objs
        for onum, val in objs:
            if onum == want:
                return val
        if 0 <= idx < len(objs):
            return objs[idx][1]
        return None

    def resolve(self, obj: Any, depth: int = 0) -> Any:
        while isinstance(obj, Ref) and depth < 32:
            obj = self.get(obj)
            depth += 1
        return obj

    # -- page tree -------------------------------------------------------

    def pages(self) -> List[Dict[str, Any]]:
        """Flattened page dicts with inherited attributes resolved."""
        root = self.resolve(self.trailer.get("Root"))
        if not isinstance(root, dict):
            raise PDFError("missing /Root catalog")
        tree = self.resolve(root.get("Pages"))
        out: List[Dict[str, Any]] = []
        if isinstance(tree, dict):
            self._walk_pages(tree, {}, out, set())
        if not out:
            # recovery: collect /Type /Page objects directly
            for num in sorted(self.xref):
                obj = self.resolve(self.get(num))
                if isinstance(obj, dict) and str(obj.get("Type", "")) == "Page":
                    out.append(obj)
        if not out:
            raise PDFError("no pages found")
        return out

    _INHERIT = ("Resources", "MediaBox", "CropBox", "Rotate")

    def _walk_pages(self, node: Dict[str, Any], inherited: Dict[str, Any],
                    out: List[Dict[str, Any]], seen: set) -> None:
        nid = id(node)
        if nid in seen or len(out) > 50_000:
            return
        seen.add(nid)
        inh = dict(inherited)
        for k in self._INHERIT:
            if k in node:
                inh[k] = node[k]
        if str(node.get("Type", "")) == "Page" or (
                "Contents" in node and "Kids" not in node):
            page = dict(node)
            for k, v in inh.items():
                page.setdefault(k, v)
            out.append(page)
            return
        for kid in self.resolve(node.get("Kids")) or []:
            k = self.resolve(kid)
            if isinstance(k, dict):
                self._walk_pages(k, inh, out, seen)


# ------------------------------------------------------------------- fonts

# Minimal Adobe Glyph List subset: the names that show up in real-world
# /Differences arrays. uniXXXX / uXXXX(XX) handled programmatically.
_AGL = {
    "space": " ", "exclam": "!", "quotedbl": '"', "numbersign": "#",
    "dollar": "$", "percent": "%", "ampersand": "&", "quotesingle": "'",
    "parenleft": "(", "parenright": ")", "asterisk": "*", "plus": "+",
    "comma": ",", "hyphen": "-", "period": ".", "slash": "/",
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "colon": ":", "semicolon": ";", "less": "<", "equal": "=",
    "greater": ">", "question": "?", "at": "@", "bracketleft": "[",
    "backslash": "\\", "bracketright": "]", "asciicircum": "^",
    "underscore": "_", "grave": "`", "braceleft": "{", "bar": "|",
    "braceright": "}", "asciitilde": "~", "quoteleft": "‘",
    "quoteright": "’", "quotedblleft": "“",
    "quotedblright": "”", "endash": "–", "emdash": "—",
    "bullet": "•", "fi": "ﬁ", "fl": "ﬂ",
    "ellipsis": "…", "dagger": "†", "daggerdbl": "‡",
    "trademark": "™", "copyright": "©", "registered": "®",
    "degree": "°", "eacute": "é", "egrave": "è",
    "agrave": "à", "ccedilla": "ç", "adieresis": "ä",
    "odieresis": "ö", "udieresis": "ü", "ntilde": "ñ",
    "Euro": "€", "sterling": "£", "yen": "¥",
    "cent": "¢", "section": "§", "paragraph": "¶",
    "minus": "−", "multiply": "×", "divide": "÷",
}


def _glyph_to_unicode(name: str) -> str:
    if len(name) == 1:
        return name
    if name in _AGL:
        return _AGL[name]
    if name.startswith("uni") and len(name) >= 7:
        try:
            return chr(int(name[3:7], 16))
        except ValueError:
            return ""
    if name.startswith("u") and 5 <= len(name) <= 7:
        try:
            return chr(int(name[1:], 16))
        except ValueError:
            return ""
    return ""


class FontDecoder:
    """Decodes show-string bytes for one font."""

    def __init__(self, doc: PDFDocument, font: Dict[str, Any]):
        self.two_byte = False
        self.cmap: Dict[int, str] = {}
        self.diffs: Dict[int, str] = {}
        self.widths: Dict[int, float] = {}
        self.default_width = 500.0
        self.has_widths = False
        subtype = str(doc.resolve(font.get("Subtype", "")))
        if subtype == "Type0":
            self.two_byte = True  # Identity-H/V and most CID encodings
            self._parse_cid_widths(doc, font)
        else:
            first = doc.resolve(font.get("FirstChar"))
            warr = doc.resolve(font.get("Widths"))
            if isinstance(first, (int, float)) and isinstance(warr, list):
                for j, w in enumerate(warr):
                    w = doc.resolve(w)
                    if isinstance(w, (int, float)):
                        self.widths[int(first) + j] = float(w)
                self.has_widths = bool(self.widths)
        tu = doc.resolve(font.get("ToUnicode"))
        if isinstance(tu, Stream):
            try:
                self._parse_tounicode(tu.data())
            except Exception:
                pass
        enc = doc.resolve(font.get("Encoding"))
        if isinstance(enc, dict):
            diffs = doc.resolve(enc.get("Differences"))
            if isinstance(diffs, list):
                code = 0
                for item in diffs:
                    item = doc.resolve(item)
                    if isinstance(item, (int, float)):
                        code = int(item)
                    elif isinstance(item, Name):
                        self.diffs[code] = _glyph_to_unicode(str(item))
                        code += 1

    def _parse_cid_widths(self, doc: PDFDocument,
                          font: Dict[str, Any]) -> None:
        """CIDFont /W array ([c [w..]] and [c1 c2 w] forms) + /DW —
        glyph advances drive the extractor's word-gap inference."""
        desc = doc.resolve(font.get("DescendantFonts"))
        if not (isinstance(desc, list) and desc):
            return
        df = doc.resolve(desc[0])
        if not isinstance(df, dict):
            return
        dw = doc.resolve(df.get("DW", 1000))
        if isinstance(dw, (int, float)):
            self.default_width = float(dw)
        warr = doc.resolve(df.get("W"))
        if isinstance(warr, list):
            i = 0
            while i + 1 < len(warr):
                c1 = doc.resolve(warr[i])
                nxt = doc.resolve(warr[i + 1])
                if not isinstance(c1, (int, float)):
                    break
                if isinstance(nxt, list):
                    for j, w in enumerate(nxt):
                        w = doc.resolve(w)
                        if isinstance(w, (int, float)):
                            self.widths[int(c1) + j] = float(w)
                    i += 2
                elif (isinstance(nxt, (int, float)) and i + 2 < len(warr)
                      and isinstance(doc.resolve(warr[i + 2]),
                                     (int, float))):
                    w = float(doc.resolve(warr[i + 2]))
                    span = int(nxt) - int(c1)
                    if 0 <= span <= 65535:
                        for c in range(int(c1), int(nxt) + 1):
                            self.widths[c] = w
                    i += 3
                else:
                    break
        self.has_widths = True  # DW default applies even with no /W

    def advance(self, raw: bytes) -> float:
        """Total glyph advance of a show string, 1/1000 text units."""
        if self.two_byte:
            codes = [
                (raw[i] << 8) | raw[i + 1] for i in range(0, len(raw) - 1, 2)
            ]
        else:
            codes = list(raw)
        return sum(self.widths.get(c, self.default_width) for c in codes)

    def _parse_tounicode(self, data: bytes) -> None:
        text = data.decode("latin-1", "replace")
        # codespace width
        m = re.search(r"begincodespacerange\s+<([0-9A-Fa-f]+)>", text)
        if m and len(m.group(1)) >= 4:
            self.two_byte = True
        for m in re.finditer(
                r"beginbfchar(.*?)endbfchar", text, re.S):
            for src, dst in re.findall(
                    r"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", m.group(1)):
                self.cmap[int(src, 16)] = self._hex_to_str(dst)
                if len(src) >= 4:
                    self.two_byte = True
        for m in re.finditer(
                r"beginbfrange(.*?)endbfrange", text, re.S):
            body = m.group(1)
            for lo, hi, dst in re.findall(
                    r"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>",
                    body):
                lo_i, hi_i = int(lo, 16), int(hi, 16)
                if len(lo) >= 4:
                    self.two_byte = True
                base = self._hex_to_str(dst)
                if not base:
                    continue
                base_cp = ord(base[-1])
                prefix = base[:-1]
                for c in range(lo_i, min(hi_i, lo_i + 65535) + 1):
                    self.cmap[c] = prefix + chr(base_cp + (c - lo_i))
            for lo, hi, arr in re.findall(
                    r"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*\[(.*?)\]",
                    body, re.S):
                lo_i = int(lo, 16)
                if len(lo) >= 4:
                    self.two_byte = True
                for k, dst in enumerate(
                        re.findall(r"<([0-9A-Fa-f]+)>", arr)):
                    self.cmap[lo_i + k] = self._hex_to_str(dst)

    @staticmethod
    def _hex_to_str(h: str) -> str:
        if len(h) % 4 == 0 and len(h) >= 4:
            try:
                return bytes.fromhex(h).decode("utf-16-be", "ignore")
            except ValueError:
                return ""
        try:
            return chr(int(h, 16))
        except ValueError:
            return ""

    def decode(self, raw: bytes) -> str:
        out = []
        if self.two_byte:
            for i in range(0, len(raw) - 1, 2):
                code = (raw[i] << 8) | raw[i + 1]
                if code in self.cmap:
                    out.append(self.cmap[code])
                # unmapped CIDs carry no recoverable text
        else:
            for b in raw:
                if b in self.cmap:
                    out.append(self.cmap[b])
                elif b in self.diffs:
                    out.append(self.diffs[b])
                else:
                    out.append(bytes([b]).decode("latin-1"))
        return "".join(out)


_DEFAULT_FONT = FontDecoder.__new__(FontDecoder)
_DEFAULT_FONT.two_byte = False
_DEFAULT_FONT.cmap = {}
_DEFAULT_FONT.diffs = {}
_DEFAULT_FONT.widths = {}
_DEFAULT_FONT.default_width = 500.0
_DEFAULT_FONT.has_widths = False


# --------------------------------------------------------- text extraction

class _PageText:
    """Interprets a content stream's text operators. Layout: a new
    output line on every text-line transition (Td/TD/T*/Tm/'/\") whose
    vertical position moved; word gaps from glyph-advance pen tracking
    when the font carries /Widths (or CID /W + /DW) — a show whose
    start sits > 0.25 em past the previous show's pen lands a space,
    which recovers words split across same-line font switches
    (Tf + Tm repositioning, e.g. smallcaps acronyms: the r4 realdocs
    miss 'introduceRAGAS(RetrievalAugmented...'). Width-less fonts
    keep the conservative fallbacks (space on same-line Td, space for
    TJ kerning < -180)."""

    def __init__(self, doc: PDFDocument, fonts: Dict[str, FontDecoder]):
        self.doc = doc
        self.fonts = fonts
        self.font = _DEFAULT_FONT
        self.parts: List[str] = []
        self._ty = 0.0
        self._line_open = False
        self._size = 1.0           # Tf operand
        self._scale = 1.0          # Tm 'a' (horizontal scale)
        self._x = 0.0              # pen target for the next show (user u.)
        self._lx = 0.0             # line-origin x (Td displaces THIS)
        self._pen: Optional[float] = None  # end of the previous show

    def _newline(self) -> None:
        if self._line_open:
            self.parts.append("\n")
            self._line_open = False
        self._pen = None           # never infer a gap across lines

    def _space(self) -> None:
        if self.parts and not self.parts[-1].endswith((" ", "\n")):
            self.parts.append(" ")

    def _show(self, raw: bytes) -> None:
        em = self._size * self._scale
        # word-gap threshold 0.12 em: measured show-gap histogram on a
        # real paper is bimodal — kerning |gap| <= 0.06, word gaps
        # 0.20-0.49 (justified setting squeezes toward 0.2, and the
        # smallcaps junctions that motivated pen tracking sit at 0.248)
        if (self.font.has_widths and self._pen is not None
                and self._x - self._pen > 0.12 * max(em, 1e-6)):
            self._space()
        s = self.font.decode(raw)
        if s:
            self.parts.append(s)
            self._line_open = True
        if self.font.has_widths:
            self._x += self.font.advance(raw) / 1000.0 * em
            self._pen = self._x

    def run(self, content: bytes) -> None:
        lex = Lexer(content)
        stack: List[Any] = []
        while True:
            try:
                tok = lex.next()
            except Exception:
                break
            if tok is None:
                break
            if tok == "<<" or tok == "[":
                try:
                    stack.append(_parse_value(lex, tok))
                except PDFError:
                    break
                continue
            if not isinstance(tok, Keyword):
                # operand: number, Name, or string bytes
                stack.append(tok)
                continue
            op = bytes(tok)
            # --- operators ---
            if op == b"BI":
                # inline image: operands up to ID, then binary up to EI
                m = re.search(rb"\bID[\x00\t\r\n ]", lex.data[lex.pos:])
                if not m:
                    break
                start = lex.pos + m.end()
                me = re.search(rb"[\x00\t\r\n ]EI\b", lex.data[start:])
                if not me:
                    break
                lex.pos = start + me.end()
                stack.clear()
                continue
            if op == b"Tf" and len(stack) >= 2:
                name, size = stack[-2], stack[-1]
                if isinstance(name, Name):
                    self.font = self.fonts.get(str(name), _DEFAULT_FONT)
                if isinstance(size, (int, float)) and size > 0:
                    self._size = float(size)
            elif op == b"Tj" and stack and isinstance(stack[-1], bytes):
                self._show(stack[-1])
            elif op in (b"'", b'"') and stack and isinstance(stack[-1], bytes):
                self._newline()
                self._x = self._lx
                self._show(stack[-1])
            elif op == b"TJ" and stack and isinstance(stack[-1], list):
                for item in stack[-1]:
                    if isinstance(item, bytes) and not isinstance(item, Keyword):
                        self._show(item)
                    elif isinstance(item, (int, float)):
                        # adjustment moves the pen by -adj/1000 em
                        self._x -= (float(item) / 1000.0
                                    * self._size * self._scale)
                        if item < -180:
                            # big negative adjustment = inter-word gap
                            # (also covers width-less fonts)
                            self._space()
            elif op in (b"Td", b"TD") and len(stack) >= 2:
                tx, ty = stack[-2], stack[-1]
                if isinstance(tx, (int, float)):
                    # Td displaces the LINE ORIGIN (not the pen)
                    self._lx += float(tx) * self._scale
                if isinstance(ty, (int, float)) and abs(ty) > 1e-6:
                    self._newline()
                    self._x = self._lx
                elif self.font.has_widths:
                    # same-line reposition: the pen-gap check at the
                    # next show decides whether a word gap opened
                    self._x = self._lx
                else:
                    self._space()
            elif op == b"T*":
                self._newline()
                self._x = self._lx
            elif op == b"Tm" and len(stack) >= 6:
                a, ty, tx = stack[-6], stack[-1], stack[-2]
                if isinstance(ty, (int, float)):
                    if abs(float(ty) - self._ty) > 1e-6:
                        self._newline()
                    self._ty = float(ty)
                if isinstance(a, (int, float)) and abs(a) > 1e-6:
                    self._scale = abs(float(a))
                if isinstance(tx, (int, float)):
                    self._lx = float(tx)
                    self._x = self._lx
            elif op == b"ET":
                self._newline()
            stack.clear()

    def text(self) -> str:
        return "".join(self.parts)


def _page_fonts(doc: PDFDocument, page: Dict[str, Any]) -> Dict[str, FontDecoder]:
    fonts: Dict[str, FontDecoder] = {}
    res = doc.resolve(page.get("Resources"))
    if isinstance(res, dict):
        fdict = doc.resolve(res.get("Font"))
        if isinstance(fdict, dict):
            for name, f in fdict.items():
                f = doc.resolve(f)
                if isinstance(f, dict):
                    try:
                        fonts[name] = FontDecoder(doc, f)
                    except Exception:
                        pass
    return fonts


def _page_content(doc: PDFDocument, page: Dict[str, Any]) -> bytes:
    contents = doc.resolve(page.get("Contents"))
    streams: List[bytes] = []
    if isinstance(contents, Stream):
        streams.append(contents.data())
    elif isinstance(contents, list):
        for c in contents:
            c = doc.resolve(c)
            if isinstance(c, Stream):
                streams.append(c.data())
    return b"\n".join(streams)


def extract_page_text(doc: PDFDocument, page: Dict[str, Any]) -> str:
    content = _page_content(doc, page)
    if not content:
        return ""
    ex = _PageText(doc, _page_fonts(doc, page))
    ex.run(content)
    # normalize: collapse trailing spaces per line, drop blank runs
    lines = [ln.rstrip() for ln in ex.text().splitlines()]
    out: List[str] = []
    for ln in lines:
        if ln or (out and out[-1]):
            out.append(ln)
    text = "\n".join(out).strip()
    # de-hyphenate end-of-line breaks ("Aug-\nmented" -> "Augmented"):
    # justified/two-column layouts split words across lines, which
    # would otherwise also split them across CHUNK boundaries and make
    # them unfindable by keyword search (pdfminer applies the same
    # normalization for the reference via markitdown)
    return re.sub(r"(?<=[a-z])-\n(?=[a-z])", "", text)


def extract_pages(data: bytes,
                  doc: Optional["PDFDocument"] = None) -> List[str]:
    """data -> per-page extracted text (the page-split parity surface;
    reference: pypdf PdfReader/PdfWriter per-page split,
    file_processor.py:161-166). Pass a pre-parsed `doc` to reuse its
    xref/object caches (the ingest pipeline extracts text THEN images —
    one parse serves both)."""
    doc = doc if doc is not None else PDFDocument(data)
    return [extract_page_text(doc, p) for p in doc.pages()]


# ------------------------------------------------------- embedded images
#
# Scanned PDFs carry their raster as a page /XObject image, not drawn
# text. The reference rasterizes whole pages with pdf2image
# (IndexerAPI/src/core/processors/utils.py:16-22); here the embedded
# image itself is recovered instead, with no renderer: DCTDecode
# streams ARE complete JPEG files (pass through untouched),
# Flate/LZW raster data is wrapped into a PNG container (zlib + CRC,
# stdlib) for the VLM, CCITT Group 3/4 fax rasters decode natively
# (ingest/ccitt.py), and generic-region JBIG2 decodes natively too
# (ingest/jbig2.py: MQ coder in C). Only symbol/halftone-coded JBIG2
# returns None (the pipeline then demands the pdf_rasterizer hook).

_IMG_PASSTHROUGH = {"DCTDecode": "image/jpeg", "DCT": "image/jpeg",
                    "JPXDecode": "image/jp2"}


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    body = tag + payload
    return (len(payload).to_bytes(4, "big") + body
            + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big"))


def _make_png(samples: bytes, width: int, height: int, bpc: int,
              color: str, palette: Optional[bytes] = None) -> bytes:
    """Wrap raw raster samples into a PNG (color: gray/rgb/palette)."""
    import numpy as np

    ctype = {"gray": 0, "rgb": 2, "palette": 3}[color]
    ncomp = 3 if color == "rgb" else 1
    row_bytes = (width * ncomp * bpc + 7) // 8
    need = row_bytes * height
    if len(samples) < need:
        samples = samples + b"\x00" * (need - len(samples))
    raw = np.frombuffer(samples[:need], dtype=np.uint8)
    raw = raw.reshape(height, row_bytes)
    filtered = np.zeros((height, row_bytes + 1), dtype=np.uint8)
    filtered[:, 1:] = raw  # filter type 0 (None) per row
    ihdr = (width.to_bytes(4, "big") + height.to_bytes(4, "big")
            + bytes([bpc, ctype, 0, 0, 0]))
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
    if color == "palette":
        out += _png_chunk(b"PLTE", palette or b"\x00\x00\x00")
    return (out + _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def _cmyk_to_rgb(samples: bytes, npx: int) -> bytes:
    import numpy as np

    arr = np.frombuffer(samples[:npx * 4], dtype=np.uint8)
    arr = arr.reshape(-1, 4).astype(np.uint16)
    inv_k = 255 - arr[:, 3]
    rgb = ((255 - arr[:, :3]) * inv_k[:, None]) // 255
    return rgb.astype(np.uint8).tobytes()


def _image_colorspace(doc: PDFDocument, cs: Any,
                      depth: int = 0) -> Tuple[str, Optional[bytes]]:
    """-> (mode, palette): mode in gray/rgb/cmyk/palette."""
    cs = doc.resolve(cs)
    if depth > 4:
        raise PDFError("colorspace nesting too deep")
    if isinstance(cs, str):  # Name subclasses str
        s = str(cs)
        if s in ("DeviceGray", "CalGray", "G"):
            return "gray", None
        if s in ("DeviceRGB", "CalRGB", "RGB"):
            return "rgb", None
        if s == "DeviceCMYK":
            return "cmyk", None
    if isinstance(cs, list) and cs:
        head = str(doc.resolve(cs[0]))
        if head == "ICCBased" and len(cs) > 1:
            st = doc.resolve(cs[1])
            n = (int(doc.resolve(st.dict.get("N", 1)) or 1)
                 if isinstance(st, Stream) else 1)
            return {1: "gray", 3: "rgb", 4: "cmyk"}.get(n, "gray"), None
        if head in ("CalRGB", "Lab"):
            return "rgb", None
        if head == "CalGray":
            return "gray", None
        if head in ("Indexed", "I") and len(cs) >= 4:
            base_mode, _ = _image_colorspace(doc, cs[1], depth + 1)
            lookup = doc.resolve(cs[3])
            pal = (lookup.data() if isinstance(lookup, Stream)
                   else lookup if isinstance(lookup, bytes) else b"")
            if base_mode == "gray":
                pal = bytes(c for g in pal for c in (g, g, g))
            elif base_mode == "cmyk":
                pal = _cmyk_to_rgb(pal, len(pal) // 4)
            hival = int(doc.resolve(cs[2]) or 0)
            return "palette", pal[:3 * (hival + 1)]
    raise PDFError("unsupported image colorspace")


def _image_to_bytes(doc: PDFDocument,
                    s: Stream) -> Optional[Tuple[str, bytes]]:
    """One image XObject -> (mime, file bytes), or None if unconvertible."""
    d = s.dict
    w = int(doc.resolve(d.get("Width", 0)) or 0)
    h = int(doc.resolve(d.get("Height", 0)) or 0)
    if w <= 0 or h <= 0:
        return None
    filters = doc.resolve(d.get("Filter"))
    if filters is None:
        filters = []
    elif not isinstance(filters, list):
        filters = [filters]
    names = [str(doc.resolve(f) or "") for f in filters]
    last = names[-1] if names else ""
    if last in _IMG_PASSTHROUGH:
        # data() applies any preceding transport filters (A85/AHx) and
        # stops at the image codec: these bytes are the image file
        return _IMG_PASSTHROUGH[last], s.data()
    if last in ("CCITTFaxDecode", "CCF"):
        # native Group 3/4 fax decode (ingest/ccitt.py) -> 1-bpc gray
        from .ccitt import decode_ccitt_params

        parms = doc.resolve(d.get("DecodeParms") or d.get("DP")) or {}
        if isinstance(parms, list):
            parms = doc.resolve(parms[-1]) or {}
        parms = {k2: doc.resolve(v) for k2, v in parms.items()}
        samples = decode_ccitt_params(s.data(), parms, w, h)
        if samples is None:
            return None
        return "image/png", _make_png(samples, w, h, 1, "gray")
    if last == "JBIG2Decode":
        # native generic-region JBIG2 (ingest/jbig2.py); symbol-coded
        # streams return None -> pdf_rasterizer hook as before
        from .jbig2 import decode_jbig2_params

        parms = doc.resolve(d.get("DecodeParms") or d.get("DP")) or {}
        if isinstance(parms, list):
            parms = doc.resolve(parms[-1]) or {}
        gstream = doc.resolve(parms.get("JBIG2Globals")) if isinstance(
            parms, dict) else None
        globals_data = b""
        if gstream is not None and hasattr(gstream, "data"):
            try:
                globals_data = gstream.data()
            except PDFError:
                globals_data = b""
        samples = decode_jbig2_params(s.data(), globals_data, w, h)
        if samples is None:
            return None
        return "image/png", _make_png(samples, w, h, 1, "gray")
    try:
        samples = s.data()
        if d.get("ImageMask"):
            mode, pal, bpc = "gray", None, 1
        else:
            mode, pal = _image_colorspace(doc, d.get("ColorSpace"))
            bpc = int(doc.resolve(d.get("BitsPerComponent", 8)) or 8)
        if mode == "cmyk":
            if bpc != 8:
                return None
            samples, mode = _cmyk_to_rgb(samples, w * h), "rgb"
        # PNG color type 2 (RGB) and 3 (palette... stored as rgb rows
        # here) only allow bit depth 8/16; sub-byte depths are gray-only
        if bpc not in (1, 2, 4, 8) or (mode == "rgb" and bpc != 8):
            return None
        dec = doc.resolve(d.get("Decode"))
        if (bpc == 1 and isinstance(dec, list) and len(dec) >= 2
                and float(doc.resolve(dec[0]) or 0) == 1.0):
            samples = bytes(b ^ 0xFF for b in samples)  # [1 0] inverts
        return "image/png", _make_png(samples, w, h, bpc, mode, pal)
    except (PDFError, ValueError):
        return None


def _page_image_streams(doc: PDFDocument, res: Any, seen: set,
                        depth: int = 0) -> List[Stream]:
    """Image XObjects reachable from a /Resources dict (Form XObjects
    recursed, cycle-guarded)."""
    out: List[Stream] = []
    res = doc.resolve(res)
    if not isinstance(res, dict) or depth > 4:
        return out
    xo = doc.resolve(res.get("XObject"))
    if not isinstance(xo, dict):
        return out
    for v in xo.values():
        key = v.num if isinstance(v, Ref) else id(v)
        if key in seen:
            continue
        seen.add(key)
        s = doc.resolve(v)
        if not isinstance(s, Stream):
            continue
        sub = str(doc.resolve(s.dict.get("Subtype", "")))
        if sub == "Image":
            out.append(s)
        elif sub == "Form":
            out.extend(_page_image_streams(
                doc, s.dict.get("Resources"), seen, depth + 1))
    return out


def extract_page_image(doc: PDFDocument,
                       page: Dict[str, Any]) -> Optional[Tuple[str, bytes]]:
    """Largest convertible embedded image on the page, as (mime, bytes)
    ready for a VLM — the native substitute for page rasterization on
    scanned documents (their raster IS this image)."""
    streams = _page_image_streams(doc, page.get("Resources"), set())

    def area(s: Stream) -> int:
        return (int(doc.resolve(s.dict.get("Width", 0)) or 0)
                * int(doc.resolve(s.dict.get("Height", 0)) or 0))

    for s in sorted(streams, key=area, reverse=True):
        got = _image_to_bytes(doc, s)
        if got is not None:
            return got
    return None


def extract_page_images(data: bytes, doc: Optional["PDFDocument"] = None
                        ) -> List[Optional[Tuple[str, bytes]]]:
    """Per-page (mime, bytes) of the dominant embedded image (None where
    the page has no convertible image). Pass a pre-parsed `doc` to skip
    a second full parse."""
    doc = doc if doc is not None else PDFDocument(data)
    return [extract_page_image(doc, p) for p in doc.pages()]


def page_count(data: bytes) -> int:
    return len(PDFDocument(data).pages())


def is_pdf(data: bytes) -> bool:
    return data.lstrip()[:5].startswith(b"%PDF-")
