"""The media front ends the port copies, against their sources, on the
same bytes: `models/{image,jpeg,audio}.py`, `ingest/flac.py` and
`native/jpeg.c`.

Each copy must be its source verbatim below the header that names it,
and each function must give the same result on the same input, exactly:
equal arrays (dtype and all), bytes and tuples, or the same exception
with the same message. The inputs are those that tests/test_{image,jpeg,
audio,flac,video}.py build in code. The JPEG decoder is each package's
own build of its `native/jpeg.c`.
"""

import io
import os
import struct

import numpy as np
import pytest

from test_audio import make_wav
from test_flac import _sig
from test_jpeg import smooth_image
from test_torch_ingest_parsers import body, same
from test_video import build_avi

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

COPIED = ["models/image.py", "models/jpeg.py", "models/audio.py",
          "ingest/flac.py"]


@pytest.mark.parametrize("path", COPIED)
def test_copy_is_verbatim(path):
    with open(os.path.join(_REPO, "rag_application_tpu", path)) as f:
        src = f.read()
    with open(os.path.join(_REPO, "rag_application_tpu_torch", path)) as f:
        copy = f.read()
    assert f"Copy of `rag_application_tpu/{path}`" in copy
    assert body(copy) == body(src)


def test_jpeg_c_is_verbatim():
    with open(os.path.join(_REPO, "rag_application_tpu/native/jpeg.c")) as f:
        src = f.read()
    with open(os.path.join(_REPO,
                           "rag_application_tpu_torch/native/jpeg.c")) as f:
        copy = f.read()
    assert copy == "/* Copy of rag_application_tpu/native/jpeg.c. */\n\n" + src


def test_port_builds_its_own_decoder():
    from rag_application_tpu_torch.models import jpeg

    jpeg.probe_jpeg(jpeg.encode_jpeg(smooth_image(8, 8)))
    assert jpeg._SRC == os.path.join(
        _REPO, "rag_application_tpu_torch", "native", "jpeg.c")
    assert os.path.dirname(jpeg._lib()._name) == os.path.dirname(jpeg._SRC)


# ------------------------------------------------------------------ PNG

def pil_png(arr, mode, **save):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG", **save)
    return buf.getvalue()


def palette_png():
    rng = np.random.default_rng(2)
    pal = Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8),
                          "RGB").convert("P", palette=Image.Palette.ADAPTIVE)
    buf = io.BytesIO()
    pal.save(buf, "PNG")
    return buf.getvalue()


def one_bit_png():
    bits = np.random.default_rng(2).random((16, 40)) < 0.5
    buf = io.BytesIO()
    Image.fromarray((bits * 255).astype(np.uint8)).convert("1").save(
        buf, "PNG")
    return buf.getvalue()


def filtered_png():
    """tests/test_image.py's gradient: PIL's optimizer picks every filter."""
    rng = np.random.default_rng(7)
    y = np.linspace(0, 255, 64)[:, None]
    x = np.linspace(0, 255, 48)[None, :]
    arr = np.stack([(y + x) / 2, y * np.ones_like(x), np.ones_like(y) * x],
                   axis=-1).astype(np.uint8)
    arr[20:30] = rng.integers(0, 256, (10, 48, 3), dtype=np.uint8)
    return pil_png(arr, "RGB", optimize=True)


def made_png():
    from rag_application_tpu_torch.ingest.pdf import _make_png

    rgb = np.random.default_rng(3).integers(0, 256, (18, 22, 3),
                                            dtype=np.uint8)
    return _make_png(rgb.tobytes(), 22, 18, 8, "rgb")


def bad_pngs():
    magic = b"\x89PNG\r\n\x1a\n"
    bad1 = magic + b"\x00\x00\x00\x0dIHDR" + b"\x00\x00\x00\x10"
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0)
    bad2 = (magic + struct.pack(">I", len(ihdr)) + b"IHDR" + ihdr
            + b"\0" * 4 + struct.pack(">I", 4) + b"PLTE" + b"\x01\x02\x03\x04"
            + b"\0" * 4)
    ihdr3 = struct.pack(">IIBBBBB", 100_000, 100_000, 8, 2, 0, 0, 0)
    bad3 = magic + struct.pack(">I", len(ihdr3)) + b"IHDR" + ihdr3 + b"\0" * 4
    return {"truncated-ihdr": bad1, "bad-plte": bad2, "too-large": bad3,
            "garbage": b"not a png"}


def rng_u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


PNGS = {
    "rgb": lambda: pil_png(rng_u8((40, 56, 3), 0), "RGB"),
    "gray": lambda: pil_png(rng_u8((33, 47), 1), "L"),
    "rgba": lambda: pil_png(rng_u8((20, 20, 4), 1), "RGBA"),
    "palette": palette_png,
    "1-bit": one_bit_png,
    "filters": filtered_png,
    "make_png": made_png,
    **{k: (lambda v=v: v) for k, v in bad_pngs().items()},
}


@pytest.mark.parametrize("case", list(PNGS))
def test_png(case):
    data = PNGS[case]()
    same("models.image", "decode_png", data)
    same("models.image", "decode_image", data)
    for size in (8, 224):
        same("models.image", "png_to_input", data, size)
        same("models.image", "image_to_input", data, size)


def test_resize_and_unknown_format():
    img = np.random.default_rng(4).random((10, 30, 3), dtype=np.float32)
    for size in (8, 31, 224):
        same("models.image", "resize_raster", img, size)
    same("models.image", "decode_image", b"GIF89a" + b"\x00" * 32)
    same("models.image", "image_to_input", b"RIFF0000WEBP", 16)


# ----------------------------------------------------------------- JPEG

def pil_jpeg(img, **save):
    buf = io.BytesIO()
    img.save(buf, "JPEG", **save)
    return buf.getvalue()


def ours(h, w, **kw):
    """The reference's numpy encoder on tests/test_jpeg.py's image (the
    port's copy writes the same bytes: `test_encode_jpeg`)."""
    from rag_application_tpu.models.jpeg import encode_jpeg

    return encode_jpeg(smooth_image(h, w), **kw)


def pil_rgb():
    return Image.fromarray((smooth_image(64, 72) * 255).astype(np.uint8))


JPEGS = {
    "444": lambda: ours(96, 130, quality=90, subsampling="444"),
    "422": lambda: ours(96, 130, quality=90, subsampling="422"),
    "420": lambda: ours(96, 130, quality=90, subsampling="420"),
    "restart": lambda: ours(80, 100, quality=88, subsampling="420",
                            restart_interval=3),
    "odd": lambda: ours(41, 53, quality=92, subsampling="420"),
    "truncated-headers": lambda: ours(96, 130, quality=80)[:60],
    "truncated-scan": lambda: ours(96, 130, quality=80)[:-40],
    "garbage": lambda: b"not a jpeg at all",
    "pil-420": lambda: pil_jpeg(pil_rgb(), quality=85),
    "pil-444": lambda: pil_jpeg(pil_rgb(), quality=85, subsampling=0),
    "pil-gray": lambda: pil_jpeg(pil_rgb().convert("L"), quality=90),
    "pil-progressive": lambda: pil_jpeg(pil_rgb(), quality=85,
                                        progressive=True),
}


@pytest.mark.parametrize("case", list(JPEGS))
def test_jpeg(case):
    data = JPEGS[case]()
    same("models.jpeg", "probe_jpeg", data)
    same("models.jpeg", "decode_jpeg", data)
    same("models.jpeg", "jpeg_to_input", data, 224)
    same("models.image", "decode_image", data)
    same("models.image", "image_to_input", data, 224)


@pytest.mark.parametrize("kw", [
    dict(quality=90, subsampling="444"), dict(quality=75, subsampling="420"),
    dict(quality=88, subsampling="422", restart_interval=3),
    dict(quality=50, subsampling="420", restart_interval=1)])
def test_encode_jpeg(kw):
    for h, w in ((96, 130), (41, 53), (8, 8)):
        same("models.jpeg", "encode_jpeg", smooth_image(h, w), **kw)
    gray = smooth_image(24, 32)[..., 0]
    same("models.jpeg", "encode_jpeg", gray, **kw)


def test_mjpeg_frames_decode_alike():
    """Frames of an MJPEG AVI, as the ingest pipeline hands them on."""
    from rag_application_tpu_torch.ingest.video import extract_frames

    frames = [ours(24, 32, quality=90) for _ in range(2)]
    for frame in extract_frames(build_avi(frames), max_frames=8):
        same("models.image", "image_to_input", frame, 224)


# ---------------------------------------------------------------- audio

WAVS = {
    "pcm8": lambda: make_wav(width=1),
    "pcm16": lambda: make_wav(),
    "pcm32": lambda: make_wav(width=4),
    "stereo": lambda: make_wav(channels=2),
    "8k": lambda: make_wav(sr=8000, freq=300),
    "44k1": lambda: make_wav(sr=44100, seconds=0.3),
    "short": lambda: make_wav(seconds=0.02),
    "long": lambda: make_wav(seconds=5.0, freq=3000),
    "garbage": lambda: b"\x00\x01not audio" * 10,
    "empty": lambda: make_wav(seconds=0.0),
}


@pytest.mark.parametrize("case", list(WAVS))
def test_wav(case):
    data = WAVS[case]()
    got = same("models.audio", "decode_wav", data)
    same("models.audio", "decode_audio", data)
    same("models.audio", "wav_to_features", data)
    same("models.audio", "wav_to_features", data, frames=64, n_mels=32)
    if got[0] == "ok":
        x, sr = got[1]
        same("models.audio", "log_mel", x, sr)
        same("models.audio", "log_mel", x, sr, n_mels=64, hop=80)
        same("models.audio", "resample", x, sr, 11025)


def test_mel_filterbank_and_resample():
    for args in ((128, 400, 16000), (40, 512, 22050)):
        same("models.audio", "_mel_filterbank", *args)
    x = np.sin(np.linspace(0, 100, 32000)).astype(np.float32)
    for sr, target in ((32000, 16000), (16000, 16000), (8000, 44100)):
        same("models.audio", "resample", x, sr, target)
    same("models.audio", "resample", np.zeros(0, np.float32), 8000)


# ----------------------------------------------------------------- FLAC

def flac(pcm, sr, **kw):
    from rag_application_tpu.ingest.flac import encode_flac

    return encode_flac(pcm, sr, **kw)


def unknown_total():
    blob = bytearray(flac(_sig(2500, 1, 16), 16000, block_size=1024))
    bits = int.from_bytes(blob[18:26], "big")
    blob[18:26] = (bits & ~((1 << 36) - 1)).to_bytes(8, "big")
    return bytes(blob)


def corrupted():
    blob = bytearray(flac(_sig(800, 1, 16), 16000))
    blob[-20] ^= 0x40
    return bytes(blob)


def rice_escape():
    pcm = np.zeros((600, 1), np.int64)
    pcm[300, 0] = 30000
    return flac(pcm, 16000, block_size=600, subframe="fixed0")


FLACS = {
    **{m: (lambda m=m: flac(_sig(3000, 2, 16), 16000, block_size=1024,
                            subframe=m))
       for m in ("verbatim", "fixed0", "fixed1", "fixed2", "auto")},
    **{f"bps{b}": (lambda b=b: flac(_sig(1500, 1, b, seed=b), 44100, bps=b,
                                    block_size=512)) for b in (8, 16, 24)},
    **{s: (lambda s=s: flac(_sig(2000, 2, 16, seed=7), 16000,
                            block_size=1000, stereo=s))
       for s in ("left_side", "right_side", "mid_side")},
    "constant": lambda: flac(np.full((2048, 1), -123, np.int64), 16000),
    "rice-escape": rice_escape,
    "one-second": lambda: flac(_sig(16000, 1, 16, seed=5), 16000),
    "unknown-total": unknown_total,
    "crc": corrupted,
    "truncated": lambda: flac(_sig(4096, 1, 16), 16000)[:4000],
    "not-flac": lambda: b"RIFF....WAVE",
}


@pytest.mark.parametrize("case", list(FLACS))
def test_flac(case):
    data = FLACS[case]()
    same("ingest.flac", "decode_flac_pcm", data)
    same("ingest.flac", "decode_flac", data)
    same("models.audio", "decode_audio", data)
    same("models.audio", "wav_to_features", data)


@pytest.mark.parametrize("kw", [
    dict(), dict(subframe="verbatim"), dict(subframe="fixed1",
                                            block_size=777),
    dict(stereo="mid_side", block_size=1000), dict(bps=24, block_size=512)])
def test_encode_flac(kw):
    bps = kw.get("bps", 16)
    pcm = _sig(2100, 2, bps, seed=9)
    same("ingest.flac", "encode_flac", pcm, 16000, **kw)
