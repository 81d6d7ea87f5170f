"""Native-lite Office (OOXML) text extraction — stdlib zipfile + XML.

Copy of `rag_application_tpu/ingest/office.py`.

The reference converts docx/pptx through markitdown
(IndexerAPI/src/core/markitdown/markdown_handler.py:9-58) or through a
remote unoserver into PDF (processors/utils.py:24-66). OOXML documents
are zip archives of XML parts, so the text layer needs no external
converter:

  docx: word/document.xml — <w:p> paragraphs of <w:r> runs holding
        <w:t> text; explicit page breaks (<w:br w:type="page"/>) and
        rendered page-break markers split pages.
  pptx: ppt/slides/slideN.xml — one page per slide, text in <a:t>
        runs grouped by <a:p> paragraphs.

Tables contribute one line per row with cells tab-separated.
"""

from __future__ import annotations

import io
import re
import zipfile
from typing import List
from xml.etree import ElementTree

_W = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
_A = "{http://schemas.openxmlformats.org/drawingml/2006/main}"


class OfficeError(ValueError):
    """Unparseable OOXML payload."""


def is_ooxml(data: bytes) -> bool:
    return data[:4] == b"PK\x03\x04"


def _open_zip(data: bytes) -> zipfile.ZipFile:
    try:
        return zipfile.ZipFile(io.BytesIO(data))
    except zipfile.BadZipFile as e:
        raise OfficeError(f"not a zip archive: {e}") from e


def ooxml_kind(data: bytes) -> str:
    """'docx' / 'pptx' / 'xlsx' / '' by content inspection."""
    if not is_ooxml(data):
        return ""
    try:
        with _open_zip(data) as z:
            names = set(z.namelist())
    except OfficeError:
        return ""
    if "word/document.xml" in names:
        return "docx"
    if any(n.startswith("ppt/slides/") for n in names):
        return "pptx"
    if "xl/workbook.xml" in names:
        return "xlsx"
    return ""


def _docx_paragraph_text(p) -> str:
    parts: List[str] = []
    for node in p.iter():
        tag = node.tag
        if tag == f"{_W}t":
            parts.append(node.text or "")
        elif tag == f"{_W}tab":
            parts.append("\t")
        elif tag == f"{_W}br" and node.get(f"{_W}type") != "page":
            parts.append("\n")
    return "".join(parts)


def _docx_has_page_break(p) -> bool:
    for br in p.iter(f"{_W}br"):
        if br.get(f"{_W}type") == "page":
            return True
    return next(p.iter(f"{_W}lastRenderedPageBreak"), None) is not None


def _docx_paragraph_segments(p) -> List[str]:
    """Paragraph text split at page-break points (explicit
    `w:br type=page` or Word's `lastRenderedPageBreak` marker): N
    breaks -> N+1 segments in document order, so text AFTER an
    in-paragraph break lands on the next page."""
    segs: List[List[str]] = [[]]
    for node in p.iter():
        tag = node.tag
        if tag == f"{_W}t":
            segs[-1].append(node.text or "")
        elif tag == f"{_W}tab":
            segs[-1].append("\t")
        elif tag == f"{_W}br":
            if node.get(f"{_W}type") == "page":
                segs.append([])
            else:
                segs[-1].append("\n")
        elif tag == f"{_W}lastRenderedPageBreak":
            segs.append([])
    return ["".join(s) for s in segs]


def extract_docx_pages(data: bytes) -> List[str]:
    """Per-page text of a .docx (pages split on explicit/rendered page
    breaks; documents without breaks come back as one page)."""
    with _open_zip(data) as z:
        try:
            xml = z.read("word/document.xml")
        except KeyError as e:
            raise OfficeError("no word/document.xml") from e
    try:
        root = ElementTree.fromstring(xml)
    except ElementTree.ParseError as e:
        raise OfficeError(f"bad document.xml: {e}") from e
    body = root.find(f"{_W}body")
    if body is None:
        return [""]
    pages: List[List[str]] = [[]]
    for child in body:
        tag = child.tag
        if tag == f"{_W}p":
            segs = _docx_paragraph_segments(child)
            if segs[0]:
                pages[-1].append(segs[0])
            elif len(segs) == 1 and pages[-1]:
                pages[-1].append("")  # blank separator line
            for seg in segs[1:]:  # each break starts a new page
                pages.append([])
                if seg:
                    pages[-1].append(seg)
        elif tag == f"{_W}tbl":
            # DIRECT rows/cells only: .iter() would also yield nested
            # tables' rows as siblings AND their paragraphs again via
            # the outer cell's recursive paragraph walk — triplicating
            # nested content. Nested tables are covered once, inside
            # their containing cell's paragraph iteration.
            for row in child.findall(f"{_W}tr"):
                cells = []
                for tc in row.findall(f"{_W}tc"):
                    cell_txt = " ".join(
                        t for t in (_docx_paragraph_text(p)
                                    for p in tc.iter(f"{_W}p")) if t)
                    cells.append(cell_txt)
                pages[-1].append("\t".join(cells))
    out = ["\n".join(p).strip() for p in pages]
    return [p for p in out if p] or [""]


def extract_pptx_pages(data: bytes) -> List[str]:
    """Per-slide text of a .pptx (one page per slide, deck order)."""
    with _open_zip(data) as z:
        slides = sorted(
            (n for n in z.namelist()
             if re.fullmatch(r"ppt/slides/slide\d+\.xml", n)),
            key=lambda n: int(re.search(r"slide(\d+)\.xml", n).group(1)))
        if not slides:
            raise OfficeError("no slides found")
        out: List[str] = []
        for name in slides:
            try:
                root = ElementTree.fromstring(z.read(name))
            except ElementTree.ParseError as e:
                raise OfficeError(f"bad {name}: {e}") from e
            paras: List[str] = []
            for p in root.iter(f"{_A}p"):
                runs = [t.text or "" for t in p.iter(f"{_A}t")]
                txt = "".join(runs).strip()
                if txt:
                    paras.append(txt)
            out.append("\n".join(paras))
    return out


def extract_pages(data: bytes) -> List[str]:
    """Dispatch by content: per-page text for docx/pptx payloads."""
    kind = ooxml_kind(data)
    if kind == "docx":
        return extract_docx_pages(data)
    if kind == "pptx":
        return extract_pptx_pages(data)
    raise OfficeError(f"unsupported OOXML kind: {kind or 'unknown'}")
