"""Native FLAC decoder (+ minimal encoder for test fixtures).

Copy of `rag_application_tpu/ingest/flac.py`.

The reference ingests compressed audio by shelling out to system
decoders via unoserver/magika-style tooling (the audio processor stub
itself returns None — app/services/file_processor stub processors); the
pipeline here previously required an external ``audio_decoder`` hook for
anything that wasn't PCM WAV. This module removes that dependency for
FLAC: a self-contained decoder for the full bitstream format
(ITU-T/xiph FLAC spec) — constant / verbatim / fixed(0-4) / LPC
subframes, Rice + Rice2 residual partitions with escape codes, wasted
bits, left-side / right-side / mid-side stereo decorrelation, CRC-8
frame-header and CRC-16 frame checks.

An encoder (``encode_flac``) producing constant / verbatim / fixed
subframes with Rice residuals exists so tests can roundtrip real
bitstreams without binary fixtures; it is deliberately small, not a
compression contender.

Pure Python + numpy: decoding is bit-serial host work (ingest-side,
off the device hot path), linear in file size; fixture-scale and
clip-scale audio decode in milliseconds.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["FLACError", "decode_flac", "decode_flac_pcm", "encode_flac"]


class FLACError(ValueError):
    """Raised on malformed or unsupported FLAC bitstreams."""


# --------------------------------------------------------------- CRCs

def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


# --------------------------------------------------------- bit reader

class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos      # next byte index
        self.bit = 0         # bits already consumed from data[byte]

    def tell_bytes(self) -> int:
        return self.byte + (1 if self.bit else 0)

    def align(self) -> None:
        if self.bit:
            self.byte += 1
            self.bit = 0

    def read(self, n: int) -> int:
        """Read n bits MSB-first as an unsigned int."""
        v = 0
        byte, bit, data = self.byte, self.bit, self.data
        while n > 0:
            if byte >= len(data):
                raise FLACError("unexpected end of stream")
            avail = 8 - bit
            take = n if n < avail else avail
            cur = data[byte]
            v = (v << take) | ((cur >> (avail - take)) & ((1 << take) - 1))
            bit += take
            if bit == 8:
                byte += 1
                bit = 0
            n -= take
        self.byte, self.bit = byte, bit
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count 0-bits up to the terminating 1-bit."""
        q = 0
        byte, bit, data = self.byte, self.bit, self.data
        while True:
            if byte >= len(data):
                raise FLACError("unexpected end of stream in unary code")
            cur = data[byte] & (0xFF >> bit)
            if cur == 0:
                q += 8 - bit
                byte += 1
                bit = 0
                continue
            top = cur.bit_length()           # position of first 1-bit
            q += (8 - bit) - top
            bit = 8 - top + 1
            if bit == 8:
                byte += 1
                bit = 0
            self.byte, self.bit = byte, bit
            return q


# ------------------------------------------------------ coded numbers

def _read_coded_number(br: _BitReader) -> int:
    """UTF-8-style variable-length frame/sample number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    ones = 0
    m = b0
    while m & 0x80:
        ones += 1
        m = (m << 1) & 0xFF
    if ones < 2 or ones > 7:
        raise FLACError("invalid coded-number prefix")
    v = b0 & (0x7F >> ones)
    for _ in range(ones - 1):
        c = br.read(8)
        if (c & 0xC0) != 0x80:
            raise FLACError("invalid coded-number continuation byte")
        v = (v << 6) | (c & 0x3F)
    return v


def _encode_coded_number(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    for total in range(2, 8):
        cap = 7 - total + 6 * (total - 1)  # bits in header + continuations
        if n < (1 << cap):
            out = bytearray(total)
            for i in range(total - 1, 0, -1):
                out[i] = 0x80 | (n & 0x3F)
                n >>= 6
            out[0] = ((0xFF << (8 - total)) & 0xFF) | n
            return bytes(out)
    raise FLACError("coded number out of range")


# ------------------------------------------------------------ decoder

_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_SR_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
             7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}

_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_residual(br: _BitReader, block_size: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise FLACError(f"reserved residual method {method}")
    pbits, esc = (4, 15) if method == 0 else (5, 31)
    porder = br.read(4)
    nparts = 1 << porder
    if (block_size >> porder) << porder != block_size:
        raise FLACError("block size not divisible by rice partitions")
    if (block_size >> porder) <= order and nparts > 1:
        raise FLACError("invalid rice partition order")
    out: List[int] = []
    for p in range(nparts):
        cnt = (block_size >> porder) - (order if p == 0 else 0)
        if cnt < 0:
            raise FLACError("invalid rice partition order")
        param = br.read(pbits)
        if param == esc:
            nb = br.read(5)
            if nb == 0:
                out.extend([0] * cnt)
            else:
                out.extend(br.read_signed(nb) for _ in range(cnt))
        else:
            rd_unary, rd = br.read_unary, br.read
            for _ in range(cnt):
                q = rd_unary()
                u = (q << param) | rd(param) if param else q
                out.append((u >> 1) ^ -(u & 1))
    return out


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise FLACError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    ebps = bps - wasted
    if stype == 0:                                   # constant
        s = [br.read_signed(ebps)] * block_size
    elif stype == 1:                                 # verbatim
        s = [br.read_signed(ebps) for _ in range(block_size)]
    elif 8 <= stype <= 12:                           # fixed
        order = stype - 8
        s = [br.read_signed(ebps) for _ in range(order)]
        res = _read_residual(br, block_size, order)
        coef = _FIXED_COEF[order]
        for i, r in enumerate(res):
            k = i + order
            acc = r
            for j, c in enumerate(coef):
                acc += c * s[k - 1 - j]
            s.append(acc)
    elif stype >= 32:                                # LPC
        order = (stype & 31) + 1
        s = [br.read_signed(ebps) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise FLACError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FLACError("negative LPC shift")
        coef = [br.read_signed(prec) for _ in range(order)]
        res = _read_residual(br, block_size, order)
        for i, r in enumerate(res):
            k = i + order
            acc = 0
            for j, c in enumerate(coef):
                acc += c * s[k - 1 - j]
            s.append(r + (acc >> shift))
    else:
        raise FLACError(f"reserved subframe type {stype}")
    arr = np.asarray(s, np.int64)
    return arr << wasted if wasted else arr


def decode_flac_pcm(data: bytes) -> Tuple[np.ndarray, int, int]:
    """FLAC bytes -> (int PCM (n, channels) int32, sample_rate, bps)."""
    if data[:4] != b"fLaC":
        raise FLACError("not a FLAC stream (missing fLaC magic)")
    pos = 4
    sr = channels = bps = 0
    total = -1
    last = False
    while not last:                                  # metadata blocks
        if pos + 4 > len(data):
            raise FLACError("truncated metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        blen = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:                               # STREAMINFO
            if blen < 34:
                raise FLACError("short STREAMINFO")
            bits = int.from_bytes(body[10:18], "big")
            sr = bits >> 44
            channels = ((bits >> 41) & 0x7) + 1
            bps = ((bits >> 36) & 0x1F) + 1
            total = bits & ((1 << 36) - 1)
        pos += 4 + blen
    if sr == 0 or channels == 0:
        raise FLACError("missing STREAMINFO")

    chans: List[List[np.ndarray]] = [[] for _ in range(channels)]
    n_out = 0
    while pos + 4 <= len(data) and (total < 0 or n_out < total or total == 0):
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            raise FLACError(f"bad frame sync at byte {pos}")
        br = _BitReader(data, pos)
        br.read(16)                                  # sync+reserved+blocking
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        ss_code = br.read(3)
        br.read(1)                                   # reserved
        _read_coded_number(br)
        if bs_code == 0:
            raise FLACError("reserved block size code")
        elif bs_code == 1:
            block_size = 192
        elif bs_code <= 5:
            block_size = 576 << (bs_code - 2)
        elif bs_code == 6:
            block_size = br.read(8) + 1
        elif bs_code == 7:
            block_size = br.read(16) + 1
        else:
            block_size = 256 << (bs_code - 8)
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise FLACError("invalid sample rate code")
        fbps = _BPS_TABLE.get(ss_code, bps) if ss_code else bps
        if fbps == 0:
            raise FLACError("reserved sample size code")
        hdr_end = br.tell_bytes()
        if _crc8(data[pos:hdr_end]) != br.read(8):
            raise FLACError(f"frame header CRC mismatch at byte {pos}")

        if ch_code < 8:
            nch = ch_code + 1
            if nch != channels:
                raise FLACError("frame/STREAMINFO channel mismatch")
            subs = [_decode_subframe(br, block_size, fbps)
                    for _ in range(nch)]
        elif ch_code in (8, 9, 10):
            if channels != 2:
                raise FLACError("stereo decorrelation in non-stereo stream")
            b0 = fbps + (1 if ch_code == 9 else 0)
            b1 = fbps + (1 if ch_code in (8, 10) else 0)
            c0 = _decode_subframe(br, block_size, b0)
            c1 = _decode_subframe(br, block_size, b1)
            if ch_code == 8:                         # left/side
                subs = [c0, c0 - c1]
            elif ch_code == 9:                       # right/side
                subs = [c1 + c0, c1]
            else:                                    # mid/side
                m = (c0 << 1) | (c1 & 1)
                subs = [(m + c1) >> 1, (m - c1) >> 1]
        else:
            raise FLACError(f"reserved channel assignment {ch_code}")

        br.align()
        frame_end = br.tell_bytes()
        crc = br.read(16)
        if _crc16(data[pos:frame_end]) != crc:
            raise FLACError(f"frame CRC-16 mismatch at byte {pos}")
        for c in range(channels):
            chans[c].append(subs[c])
        n_out += block_size
        pos = br.tell_bytes()

    if not chans[0]:
        raise FLACError("no audio frames")
    pcm = np.stack([np.concatenate(c) for c in chans], axis=1)
    # total_samples == 0 in STREAMINFO means "unknown" (streamed/pipe
    # encodes) — only trim when a real count is present.
    if 0 < total < pcm.shape[0]:
        pcm = pcm[:total]
    return pcm.astype(np.int32), sr, bps


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """FLAC bytes -> (mono float32 in [-1, 1], sample_rate) — the
    pipeline's audio-decoder contract (ingest/pipeline.py audio hook)."""
    pcm, sr, bps = decode_flac_pcm(data)
    x = pcm.astype(np.float32) / float(1 << (bps - 1))
    return x.mean(axis=1), sr


# ------------------------------------------------------------ encoder

class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int) -> None:
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_bytes(self, b: bytes) -> None:
        for x in b:
            self.write(x, 8)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _best_rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.abs(res).mean())
    k = 0
    while (1 << k) < mean * 2 and k < 14:
        k += 1
    return k


def _write_residual(bw: _BitWriter, res: np.ndarray, *, porder: int,
                    order: int) -> None:
    bw.write(0, 2)                                   # method 0: 4-bit rice
    bw.write(porder, 4)
    nparts = 1 << porder
    n = len(res) + order
    start = 0
    for p in range(nparts):
        cnt = (n >> porder) - (order if p == 0 else 0)
        part = res[start:start + cnt]
        start += cnt
        u = (np.abs(part.astype(np.int64)) * 2
             - (part < 0).astype(np.int64)).astype(np.int64)
        param = _best_rice_param(part)
        if len(part) and int(u.max() >> param) > 48:  # pathological: escape
            nb = max(1, int(np.abs(part).max()).bit_length() + 1)
            bw.write(15, 4)
            bw.write(nb, 5)
            for v in part:
                bw.write(int(v), nb)
            continue
        bw.write(param, 4)
        for uv in u:
            bw.write_unary(int(uv) >> param)
            if param:
                bw.write(int(uv), param)


def _encode_subframe(bw: _BitWriter, s: np.ndarray, bps: int,
                     mode: str) -> None:
    s = s.astype(np.int64)
    if mode == "auto":
        if len(s) and (s == s[0]).all():
            mode = "constant"
        elif len(s) < 3:
            mode = "verbatim"
        else:
            mode = "fixed2"
    if mode == "constant":
        bw.write(0, 1 + 6 + 1)
        bw.write(int(s[0]), bps)
        return
    if mode == "verbatim":
        bw.write(1 << 1, 8)                          # pad0 + type 000001 + nowaste
        for v in s:
            bw.write(int(v), bps)
        return
    order = int(mode[len("fixed"):])
    bw.write((8 + order) << 1, 8)                    # pad0 + type 001xxx + nowaste
    for v in s[:order]:
        bw.write(int(v), bps)
    res = s.copy()
    for _ in range(order):
        res = np.diff(res)
    _write_residual(bw, res, porder=0, order=order)


def encode_flac(pcm: np.ndarray, sr: int, *, bps: int = 16,
                block_size: int = 4096, subframe: str = "auto",
                stereo: Optional[str] = None) -> bytes:
    """Encode int PCM (n,) or (n, channels) to a FLAC stream.

    ``subframe``: auto | constant | verbatim | fixed0..fixed4.
    ``stereo``: None (independent) | left_side | right_side | mid_side.
    Fixture-grade: correctness over ratio (tests roundtrip the decoder
    against this output bit-exactly).
    """
    pcm = np.asarray(pcm, np.int64)
    if pcm.ndim == 1:
        pcm = pcm[:, None]
    n, channels = pcm.shape
    if stereo is not None and channels != 2:
        raise FLACError("stereo decorrelation needs 2 channels")
    out = bytearray(b"fLaC")
    info = _BitWriter()
    info.write(block_size, 16)
    info.write(block_size, 16)
    info.write(0, 24)
    info.write(0, 24)
    info.write(sr, 20)
    info.write(channels - 1, 3)
    info.write(bps - 1, 5)
    info.write(n, 36)
    info.write_bytes(b"\0" * 16)                     # md5 unset
    out += bytes([0x80, 0, 0, 34]) + info.getvalue()

    for fi, off in enumerate(range(0, n, block_size)):
        blk = pcm[off:off + block_size]
        bsz = blk.shape[0]
        ch_code = {None: channels - 1, "left_side": 8, "right_side": 9,
                   "mid_side": 10}[stereo]
        hdr = _BitWriter()
        hdr.write(0b1111_1111_1111_1000, 16)
        hdr.write(7, 4)                              # 16-bit block size - 1
        hdr.write(13 if sr < 65536 else 0, 4)        # 16-bit Hz / streaminfo
        hdr.write(ch_code, 4)
        hdr.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps], 3)
        hdr.write(0, 1)
        hdr.write_bytes(_encode_coded_number(fi))
        hdr.write(bsz - 1, 16)
        if sr < 65536:
            hdr.write(sr, 16)
        hbytes = hdr.getvalue()
        fw = _BitWriter()
        fw.write_bytes(hbytes)
        fw.write(_crc8(hbytes), 8)
        if stereo is None:
            for c in range(channels):
                _encode_subframe(fw, blk[:, c], bps, subframe)
        else:
            left, right = blk[:, 0], blk[:, 1]
            side = left - right
            if stereo == "left_side":
                _encode_subframe(fw, left, bps, subframe)
                _encode_subframe(fw, side, bps + 1, subframe)
            elif stereo == "right_side":
                _encode_subframe(fw, side, bps + 1, subframe)
                _encode_subframe(fw, right, bps, subframe)
            else:
                mid = (left + right) >> 1
                _encode_subframe(fw, mid, bps, subframe)
                _encode_subframe(fw, side, bps + 1, subframe)
        fw.align()
        body = fw.getvalue()
        out += body + struct.pack(">H", _crc16(body))
    return bytes(out)
