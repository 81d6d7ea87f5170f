"""Parity of the port's int8-KV decode attention (`ops.decode_attn`) with
the JAX package's, whose Pallas kernel runs in interpret mode on the CPU.

Tolerance: both keep the reference kernel's rounding points (bf16 query,
f32 dots and sums, ``p * v_scale`` rounded to bf16). The JAX kernel
takes the softmax online over S blocks of up to 512 slots, the port's
plain version in one pass, so a slot's bf16-rounded ``p * v_scale`` may
sit on the other side of a rounding edge: each term can move by one
bf16 ulp (2^-8 relative). Outputs are held to 2^-8 of the output's max
magnitude plus 2^-8 of max|V| / sqrt(visible slots), the size of such
rounding noise summed over the visible slots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_application_tpu.ops import decode_attn as jd
from rag_application_tpu_torch.ops import decode_attn as td


def _quant(r, shape):
    x = r.standard_normal(shape)
    s = np.maximum(np.abs(x).max(-1), 1e-12) / 127.0
    q = np.clip(np.round(x / s[..., None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _both(r, B, KVH, G, HD, S, mask):
    q = r.standard_normal((B, 1, KVH, G, HD)).astype(np.float32)
    kq, ks = _quant(r, (B, S, KVH, HD))
    vq, vs = _quant(r, (B, S, KVH, HD))
    qj = jnp.asarray(q, jnp.bfloat16)
    j = np.asarray(jd.decode_attend_int8(
        qj, {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)}, jnp.asarray(mask)),
        np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    t = td.decode_attend_int8(
        qt, {"q": torch.from_numpy(kq), "s": torch.from_numpy(ks)},
        {"q": torch.from_numpy(vq), "s": torch.from_numpy(vs)},
        torch.from_numpy(mask))
    assert t.shape == (B, 1, KVH, G, HD) and t.dtype == torch.bfloat16
    vmax = float((np.abs(vq) * vs[..., None]).max())
    return t.float().numpy(), j, vmax


def _tol(j, vmax, mask):
    n = max(int(mask.sum(-1).max()), 1)
    return 2.0 ** -8 * (np.abs(j).max() + vmax / np.sqrt(n))


@pytest.mark.parametrize("B,KVH,G,HD,S", [
    (4, 4, 2, 64, 256),    # the reference's measured geometry (C=8)
    (4, 8, 4, 128, 256),   # the C=32 geometry (llama-8B-like)
    (2, 2, 2, 64, 512),
    (4, 1, 4, 128, 128),   # KVH=1
    (2, 2, 7, 64, 256),    # G=7: the CUDA kernel pads its head tile
    (2, 2, 16, 64, 256),   # G=16: two head tiles
])
def test_plain_matches_pallas(B, KVH, G, HD, S):
    r = np.random.default_rng(0)
    mask = r.integers(0, 2, (B, S)).astype(bool)
    mask[:, :4] = True
    t, j, vmax = _both(r, B, KVH, G, HD, S, mask)
    assert np.abs(t - j).max() <= _tol(j, vmax, mask)


def test_masked_prefix_and_fully_masked_rows():
    """Blocks whose every slot is masked must not poison the softmax, and
    a row with no visible slot is 0 in both packages."""
    B, KVH, G, HD, S = 3, 2, 2, 64, 1024   # two 512-slot blocks in JAX
    r = np.random.default_rng(1)
    mask = np.zeros((B, S), bool)
    mask[0, -3:] = True          # only the tail block has visible slots
    mask[1, 700:900] = True
    t, j, vmax = _both(r, B, KVH, G, HD, S, mask)
    assert np.abs(t - j).max() <= _tol(j, vmax, mask)
    assert (t[2] == 0).all() and (j[2] == 0).all()


def test_geometry_gate_matches_jax():
    for s in (32, 96, 100, 128, 256, 288, 512, 640, 1000, 1024, 1056):
        assert td.pick_block(s) == jd.pick_block(s), s
        for kvh in (1, 2, 3, 4, 8):
            for hd in (25, 32, 64, 96, 128):
                assert (td.supported(seq_len=s, kv_heads=kvh, head_dim=hd)
                        == jd.supported(seq_len=s, kv_heads=kvh,
                                        head_dim=hd)), (s, kvh, hd)


def test_kernel_chunking_covers_the_cache():
    """The CUDA wrapper's slot chunks: multiples of 32 whose block fits
    the kernel's shared memory (4 blocks a SM where they can), finer for
    small batches but S cut into at most 8 chunks unless the shared memory
    asks for more; a geometry whose smallest block does not fit raises."""
    for B, KVH, G, hd, S in ((64, 4, 8, 64, 1024), (1, 4, 8, 64, 256),
                             (64, 4, 8, 64, 288), (8, 8, 4, 128, 1024),
                             (16, 4, 7, 64, 1024), (16, 4, 16, 64, 1024),
                             (1, 1, 8, 1024, 1024)):
        c = td._pick_chunk(B, KVH, G, S, hd)
        assert c % 32 == 0 and 32 <= c <= 256
        assert td._smem_bytes(G, hd, c) <= td._SMEM_MAX
    # the main decode shape: 128-slot blocks, 4 of them share an SM
    assert td._pick_chunk(64, 4, 8, 1024, 64) == 128
    assert td._smem_bytes(8, 64, 128) <= td._SMEM_TARGET
    # the chat's B 1: 8 chunks of 128 slots, 32 blocks
    assert td._pick_chunk(1, 4, 8, 1024, 64) == 128
    assert td._pick_chunk(1, 4, 8, 256, 64) == 32
    # hd 128: the shared memory halves the chunk past 8 splits
    assert td._pick_chunk(8, 8, 4, 1024, 128) == 64
    with pytest.raises(ValueError, match="shared memory"):
        td._pick_chunk(1, 1, 64, 1024, 1024)
