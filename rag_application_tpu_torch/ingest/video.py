"""Native video frame extraction for ingest (MJPEG-in-AVI).

Copy of `rag_application_tpu/ingest/video.py`.

The reference declares a video processor but returns None for every
video file (app/core/file_processors: the video branch is a stub; the
IndexerAPI fan-out likewise has no video handler). Here the common
scanner/camera container — an AVI whose streams are Motion-JPEG — is
parsed natively: RIFF chunk walk, ``movi`` list (including ``rec ``
record lists in interleaved files), ``..dc``/``..db`` frame chunks,
each an independent JPEG. Sampled key frames feed the SAME page path
as scanned-PDF images — VLM description when a describer is
configured, otherwise a native baseline-JPEG decode (models/jpeg.py)
straight into the multimodal tower. Codecs beyond MJPEG (H.264 in
MP4/MKV…) are out of native scope and still fail into the ledger,
exactly as the reference's stub does.

Frames pass through byte-verbatim here (the DCTDecode contract in
ingest/pdf.py); decoding happens at the consumer.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

__all__ = ["VideoError", "extract_frames", "probe_avi"]


class VideoError(ValueError):
    """Not an AVI, or no natively decodable (MJPEG) video stream."""


_JPEG_MAGIC = b"\xff\xd8\xff"
_MAX_FRAMES_SCANNED = 100_000


def _chunks(data: bytes, pos: int, end: int
            ) -> Iterator[Tuple[bytes, int, int]]:
    """RIFF chunk walk -> (fourcc, payload_start, payload_size). LIST
    chunks yield the literal ``b"LIST"`` fourcc; their list-type is the
    first 4 payload bytes (callers check ``data[p:p+4]``)."""
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack(
            "<I", data[pos + 4:pos + 8])[0]
        payload = pos + 8
        if payload + size > end:
            size = max(0, end - payload)          # tolerate truncation
        yield fourcc, payload, size
        pos = payload + size + (size & 1)         # word-aligned


def probe_avi(data: bytes) -> dict:
    """AVI main-header facts (frame count, size, rate) without decoding.
    Raises VideoError when the container is not RIFF/AVI."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise VideoError("not a RIFF/AVI container")
    info = {"frames": 0, "width": 0, "height": 0, "usec_per_frame": 0,
            "codecs": []}
    for fourcc, p, size in _chunks(data, 12, len(data)):
        if fourcc != b"LIST":
            continue
        if data[p:p + 4] != b"hdrl":
            continue
        for sub, sp, ssz in _chunks(data, p + 4, p + size):
            if sub == b"avih" and ssz >= 16:
                usec, _rate, _pad, _flags = struct.unpack(
                    "<IIII", data[sp:sp + 16])
                info["usec_per_frame"] = usec
                if ssz >= 40:
                    info["frames"], _init, _streams, _buf, w, h = \
                        struct.unpack("<IIIIII", data[sp + 16:sp + 40])
                    info["width"], info["height"] = w, h
            elif sub == b"LIST" and data[sp:sp + 4] == b"strl":
                for s2, s2p, s2sz in _chunks(data, sp + 4, sp + ssz):
                    if s2 == b"strh" and s2sz >= 8:
                        stype = data[s2p:s2p + 4]
                        handler = data[s2p + 4:s2p + 8]
                        if stype == b"vids":
                            info["codecs"].append(
                                handler.decode("latin1").strip("\x00 "))
    return info


def extract_frames(data: bytes, *, max_frames: int = 8) -> List[bytes]:
    """Evenly sampled JPEG frames from an MJPEG AVI.

    Walks every ``movi`` list for video-data chunks (``NNdc``/``NNdb``)
    whose payload starts with the JPEG SOI marker, then picks
    ``max_frames`` evenly spaced ones (always including the first).
    Raises VideoError when the file is not AVI or carries no JPEG
    frames (other codecs -> caller's ledger/hook path)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise VideoError("not a RIFF/AVI container")
    spans: List[Tuple[int, int]] = []          # lazy: slice at selection

    def collect(pos: int, end: int, depth: int) -> None:
        for sub, sp, ssz in _chunks(data, pos, end):
            if len(spans) >= _MAX_FRAMES_SCANNED:
                return
            if (sub == b"LIST" and data[sp:sp + 4] == b"rec " and
                    depth == 0):
                # interleaved AVIs group each frame's chunks in a
                # 'rec ' record list inside movi (AVI 1.0 spec)
                collect(sp + 4, sp + ssz, depth + 1)
            elif len(sub) == 4 and sub[2:4] in (b"dc", b"db") and ssz > 4:
                if data[sp:sp + 3] == _JPEG_MAGIC:
                    spans.append((sp, ssz))

    for fourcc, p, size in _chunks(data, 12, len(data)):
        if fourcc != b"LIST" or data[p:p + 4] != b"movi":
            continue
        collect(p + 4, p + size, 0)
    if not spans:
        raise VideoError("no MJPEG frames in AVI (unsupported codec)")
    if max_frames <= 0 or len(spans) <= max_frames:
        picks = spans
    else:
        step = len(spans) / max_frames
        picks = [spans[int(i * step)] for i in range(max_frames)]
    return [bytes(data[s:s + n]) for s, n in picks]


def frame_timestamps(info: dict, n_picked: int,
                     total: Optional[int] = None) -> List[float]:
    """Approximate seconds-offsets for evenly sampled frames, from the
    avih frame clock (0.0.. when the header lacks timing)."""
    usec = info.get("usec_per_frame") or 0
    total = total or info.get("frames") or n_picked
    if n_picked <= 0:
        return []
    step = max(total / n_picked, 1.0)
    return [round(i * step * usec / 1e6, 3) for i in range(n_picked)]
