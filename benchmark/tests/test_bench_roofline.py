"""The roofline arithmetic against hand counts at small shapes."""

import pytest

from benchmark import roofline

CFG = {"num_hidden_layers": 2, "hidden_size": 8, "intermediate_size": 12,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2,
       "vocab_size": 10}


def test_scan_counts():
    # 2 queries x 256 rows x 8 columns: 2 * 2 * 256 * 8 operations; bytes:
    # the int8 rows, the int8 queries, an (f32, s32) pair per 128-row bin
    assert roofline.scan_int8(2, 256, 8) == (8192.0, 2048 + 16 + 2 * 2 * 8)
    # bf16 prefix of 4 columns: bf16 rows and queries, an f32 inverse norm
    # a row, and the bins
    assert roofline.scan_bf16_prefix(2, 256, 4) == (
        4096.0, 2 * 256 * 4 + 2 * 2 * 4 + 4 * 256 + 2 * 2 * 8)


def test_bound_takes_the_slower_of_compute_and_bandwidth():
    assert roofline.bound_s((2e15, 1.0), 1e15) == pytest.approx(2.0)
    assert roofline.bound_s((1.0, 6.7e12), 1e15) == pytest.approx(2.0)
    q, n, d, p = 8192, 1 << 20, 768, 64
    want = 2 * q * n * d / 1.979e15 + 2 * q * n * p / 0.989e15
    assert roofline.scan_bound_s(q, n, d, p) == pytest.approx(want)
    assert roofline.scan_bound_s(q, n, d, 0) == pytest.approx(
        2 * q * n * d / 1.979e15)


def test_decode_attention_bytes():
    # rows with 3 and 5 visible slots, 2 kv heads of 4 lanes, 2 groups:
    # K and V int8 (2 x 4 B) and their f32 scales (2 x 4 B) a slot and
    # head, one mask byte a slot, bf16 q and out (2 rows x 4 heads x 4)
    want = 8 * 2 * (8 + 8) + 8 + 2 * 4 * 4 * 2 * 2
    assert roofline.decode_attn_bytes([3, 5], 2, 2, 4) == want


def test_decoder_flops_by_hand():
    # projections a layer: q 8x8, k and v 8x4 each, o 8x8, gate/up/down
    # 8x12 each = 64 + 64 + 64 + 288 = 480 MACs; attention at position 5
    # over 6 slots: 4 heads x 2 lanes x 6 x 2 products = 96 MACs; head
    # 8 x 10 = 80 MACs
    assert roofline.decoder_token_flops(CFG, 5, False) == 2 * 2 * (480 + 96)
    assert roofline.decoder_token_flops(CFG, 5, True) == \
        2 * 2 * (480 + 96) + 2 * 80


def test_prefill_is_its_tokens_with_one_head():
    start, tokens = 7, 5
    want = sum(roofline.decoder_token_flops(CFG, start + j, False)
               for j in range(tokens)) + 2 * 80
    assert roofline.prefill_flops(CFG, start, tokens) == pytest.approx(want)
