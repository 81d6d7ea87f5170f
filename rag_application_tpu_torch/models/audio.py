"""Audio front-end: WAV decode + log-mel spectrogram (stdlib + numpy).

Copy of `rag_application_tpu/models/audio.py`.

The reference embeds audio through ImageBind's waveform->mel->ViT path
(app/core/models/imagebind/imagebind_handler.py:23-32, modality
ModalityType.AUDIO). Here the host computes the same class of feature —
a fixed-shape log-mel spectrogram — and the device encoder ingests it
as patch tokens next to text/image tokens (models/encoder.py,
ImageBind-style single tower).

Native WAV (PCM 8/16/32-bit + IEEE float) is decoded with the stdlib
`wave` module; compressed formats (mp3/flac/...) need a decoder hook at
the pipeline level.
"""

from __future__ import annotations

import io
import wave
from typing import Tuple

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 400       # 25 ms @ 16 kHz
HOP = 160         # 10 ms
N_MELS = 128
N_FRAMES = 256    # ~2.56 s context, padded/trimmed


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (mono float32 in [-1, 1], sample_rate)."""
    try:
        with wave.open(io.BytesIO(data)) as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            raw = w.readframes(n)
    except (wave.Error, EOFError) as e:
        raise ValueError(f"not a decodable WAV file: {e}") from e
    if width == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:  # packed 24-bit
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)
              | (b[:, 1].astype(np.int32) << 8)
              | (b[:, 2].astype(np.int32) << 16)) << 8) >> 8
        x = x.astype(np.float32) / 8388608.0
    elif width == 4:
        # WAVE_FORMAT_IEEE_FLOAT also reports width 4; PCM int32 values
        # interpreted as float would be denormal-tiny, so sniff range
        xf = np.frombuffer(raw, "<f4")
        if np.isfinite(xf).all() and (np.abs(xf) <= 64.0).all():
            x = xf.astype(np.float32)
        else:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def resample(x: np.ndarray, sr: int, target: int = SAMPLE_RATE) -> np.ndarray:
    if sr == target or x.size == 0:
        return x.astype(np.float32)
    n_out = max(1, int(round(len(x) * target / sr)))
    t_in = np.arange(len(x), dtype=np.float64) / sr
    t_out = np.arange(n_out, dtype=np.float64) / target
    return np.interp(t_out, t_in, x).astype(np.float32)


def _mel_filterbank(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, n_fft//2 + 1)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2),
                                    n_mels + 2))
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, c, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(c - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - c, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def log_mel(x: np.ndarray, sr: int = SAMPLE_RATE, *, n_fft: int = N_FFT,
            hop: int = HOP, n_mels: int = N_MELS) -> np.ndarray:
    """Waveform -> (frames, n_mels) log-mel spectrogram."""
    if sr != SAMPLE_RATE:
        x = resample(x, sr)
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = x[idx] * np.hanning(n_fft).astype(np.float32)[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    mels = spec @ _mel_filterbank(n_mels, n_fft, SAMPLE_RATE).T
    return np.log(mels + 1e-6).astype(np.float32)


def decode_audio(data: bytes) -> Tuple[np.ndarray, int]:
    """Audio bytes (WAV or FLAC, by magic) -> (mono float32, rate).
    FLAC decodes natively (ingest/flac.py); other compressed formats
    still need the pipeline's audio_decoder hook."""
    if data[:4] == b"fLaC":
        from ..ingest.flac import decode_flac
        return decode_flac(data)
    return decode_wav(data)


def wav_to_features(data: bytes, *, frames: int = N_FRAMES,
                    n_mels: int = N_MELS) -> np.ndarray:
    """WAV/FLAC bytes -> fixed-shape (frames, n_mels) normalized log-mel
    — the encoder's audio input (static shape for XLA)."""
    x, sr = decode_audio(data)
    m = log_mel(x, sr, n_mels=n_mels)
    if m.shape[0] >= frames:
        m = m[:frames]
    else:
        m = np.pad(m, ((0, frames - m.shape[0]), (0, 0)))
    mu, sd = float(m.mean()), float(m.std())
    return ((m - mu) / max(sd, 1e-6)).astype(np.float32)
