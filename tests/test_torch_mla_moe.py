"""DeepSeek-V2's block in the port (multi-head latent attention with YaRN
RoPE and an int8 latent cache, a dense first layer, routed + shared
experts) held to the plain reference `benchmark/reference/deepseek_v2.py`
on seeded random weights, at a small size of the same kinds: 3 layers
(the first dense), hidden 64, 4 heads, kv_lora_rank 32, rope 16, nope
16, v 16, 8 experts top-2 and 1 shared, YaRN on (its ramp inside the
tested positions: original context 32).

Each tolerance states its reason and sits well below what the reference
with int4 weights in the port's place reads (`_int4_gap`)."""

import asyncio
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.drivers import generate_mla_moe as drv
from benchmark.reference import deepseek_v2 as ref
from rag_application_tpu_torch.llm.scheduler import ContinuousBatcher
from rag_application_tpu_torch.models import decoder as dec
from rag_application_tpu_torch.models import mla, moe
from rag_application_tpu_torch.ops import decode_attn as da
from rag_application_tpu_torch.ops import moe as omoe
from rag_application_tpu_torch.utils.observability import METRICS

CPU = torch.device("cpu")
SEED = 2 ** 31 + 24_001
CFG = {"vocab_size": 211, "hidden_size": 64, "num_hidden_layers": 3,
       "num_attention_heads": 4, "num_key_value_heads": 4,
       "intermediate_size": 96, "max_position_embeddings": 4096,
       "rope_theta": 10000, "rms_norm_eps": 1e-6, "kv_lora_rank": 32,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
       "q_lora_rank": None, "n_routed_experts": 8, "n_shared_experts": 1,
       "moe_intermediate_size": 32, "num_experts_per_tok": 2,
       "first_k_dense_replace": 1, "norm_topk_prob": False,
       "routed_scaling_factor": 1.0, "topk_method": "greedy",
       "scoring_func": "softmax", "eos_token_id": 2,
       "rope_scaling": {"type": "yarn", "factor": 40,
                        "original_max_position_embeddings": 32,
                        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                        "mscale_all_dim": 0.707},
       "serving": {"dtype": "float32", "weights_int8": True,
                   "kv_int8": False, "attn_kernel": False}}
SERVE = {"dtype": "bfloat16", "weights_int8": True, "kv_int8": True,
         "attn_kernel": True}
IDS = [int(t) for t in np.random.default_rng(3).integers(3, 211, 40)]


def _cfg(**serving):
    c = copy.deepcopy(CFG)
    c["serving"].update(serving)
    return c


_MODELS = {}


def _model(cfg):
    key = repr(sorted(cfg["serving"].items()))
    if key not in _MODELS:
        _MODELS[key] = (drv.build_params(cfg, SEED, CPU),
                        drv.decoder_config(cfg))
    return _MODELS[key]


_REF = {}


def _ref_logits(bits=8):
    if bits not in _REF:
        _REF[bits] = ref.logits(ref.Weights(SEED, CFG, CPU, bits=bits),
                                IDS, 0)
    return _REF[bits]


def _int4_gap():
    return float((_ref_logits(4) - _ref_logits(8)).abs().max())


def _prefill_logits(params, cfg, ids):
    T = len(ids)
    ck, cv = dec.init_kv_cache(cfg, 1, T, device="cpu")
    h, _, _ = dec.forward(params, cfg, torch.tensor([ids]),
                          torch.arange(T)[None], ck, cv)
    return dec._project(params, cfg, h[0])


def test_prefill_logits_match_the_reference_in_float32():
    """The port's expanded prefill in f32 over the int8 weights the
    reference dequantizes: only the order of f32 sums differs, ~1e-5
    on logits of ~4; 1e-4 leaves room and is 10^4 below the int4
    control."""
    params, cfg = _model(CFG)
    got = _prefill_logits(params, cfg, IDS)
    gap = float((got - _ref_logits()).abs().max())
    assert gap < 1e-4 < _int4_gap() / 1000, (gap, _int4_gap())


def test_prefill_then_decode_through_the_int8_latent_cache_and_kernel():
    """Serving precision: bf16 activations, int8 latent cache, and every
    T = 1 step through `decode_attend_int8` (its plain version here).
    The prompt's first 30 tokens prefill, the other 10 are fed one a
    step; every step's logits against the reference's full forward.
    bf16 rounds each activation to 2^-9 relative and the latent's int8
    codes to 1/254 of its largest value, which at hidden 64 move the
    logits (~4) by up to ~0.6 (measured 0.57); 1.2 leaves room and
    stays under half the int4 control (3.47)."""
    params, cfg = _model(_cfg(**SERVE))
    T0, S = 30, 64
    ck, cv = dec.init_kv_cache(cfg, 1, S, device="cpu")
    assert ck["q"].shape == (3, 1, S, 1, 48) and ck["s"].shape == (3, 1, S, 1)
    assert cv.numel() == 0
    logits, ck, cv = dec.prefill(params, cfg, torch.tensor([IDS[:T0]]),
                                 torch.tensor([T0]), ck, cv)
    outs = [logits[0]]
    slot_pos = torch.where(torch.arange(S) < T0, torch.arange(S),
                           2 ** 30)[None].int()
    before = da.decode_attend_int8
    calls = []

    def counted(*a, **k):
        calls.append(a[1]["q"].shape)
        return before(*a, **k)

    da.decode_attend_int8 = counted
    try:
        for j in range(T0, len(IDS)):
            slot_pos[0, j] = j
            lg, ck, cv = dec.decode_step(params, cfg, torch.tensor([IDS[j]]),
                                         torch.tensor([j]), j, ck, cv,
                                         slot_positions=slot_pos)
            outs.append(lg[0])
    finally:
        da.decode_attend_int8 = before
    assert len(calls) == 3 * (len(IDS) - T0)
    assert set(calls) == {(1, S, 1, 48)}
    gap = float((torch.stack(outs) - _ref_logits()[T0 - 1:]).abs().max())
    assert gap < 1.2 < _int4_gap() / 2, (gap, _int4_gap())


def test_absorbed_attention_equals_expanded():
    """Both ways over one int8 (and one f32) latent cache, at T 5 and
    T 1, f32: exact arithmetic agrees; the order of f32 sums differs."""
    g = torch.Generator().manual_seed(1)
    B, T, S, nh, r, dr, dn, dv = 2, 5, 12, 4, 32, 16, 16, 16
    q_nope = torch.randn(B, T, nh, dn, generator=g)
    q_pe = torch.randn(B, T, nh, dr, generator=g)
    lat = torch.randn(B, S, 1, r + dr, generator=g)
    w_uk = dec.quantize_decoder_params(
        {"w": torch.randn(r, nh * dn, generator=g) / math.sqrt(r)})["w"]
    w_uv = torch.randn(r, nh * dv, generator=g) / math.sqrt(r)
    pos = torch.tensor([[5, 6, 7, 8, 9], [2, 3, 4, 5, 6]])
    mask = torch.arange(S)[None, None] <= pos[:, :, None]
    for cache in (lat, dec._kv_quantize(lat)):
        for t in (T, 1):
            a = mla.absorbed(q_nope[:, :t], q_pe[:, :t], cache, w_uk, w_uv,
                             mask[:, :t], 0.11, r, False)
            e = mla.expanded(q_nope[:, :t], q_pe[:, :t], cache, w_uk, w_uv,
                             mask[:, :t], 0.11, r)
            assert torch.allclose(a, e, atol=1e-5, rtol=1e-5)
    # the kernel route (its plain version) over the int8 cache at T 1
    cache = dec._kv_quantize(lat)
    k = mla.absorbed(q_nope[:, :1], q_pe[:, :1], cache, w_uk, w_uv,
                     mask[:, :1], 0.11, r, True)
    e = mla.expanded(q_nope[:, :1], q_pe[:, :1], cache, w_uk, w_uv,
                     mask[:, :1], 0.11, r)
    # the kernel's q and bf16(p * scale) round to bf16: 2^-8 relative
    assert torch.allclose(k, e, atol=2e-2, rtol=2e-2)


def _naive_experts(x, ids, w, gate, up, down):
    """A per-token loop over each token's chosen experts, in f32."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for j in range(ids.shape[1]):
            e = int(ids[t, j])
            h = (torch.nn.functional.silu(x[t] @ gate[e])
                 * (x[t] @ up[e])) @ down[e]
            out[t] += w[t, j] * h
    return out


@pytest.mark.parametrize("tokens", [3, 40, 900])
def test_grouped_experts_match_a_per_expert_loop(tokens):
    """`moe_experts` (block-padded, expert-sorted layout; 900 tokens take
    64-row blocks) against a per-token loop over the same int8 weights
    dequantized, in f32: 1e-5 covers the order of sums; the f32 run
    checks the layout and the combine. Routing agreement of the router
    on bf16 activations against f32 is counted: near-ties may flip, the
    large majority may not."""
    g = torch.Generator().manual_seed(tokens)
    E, H, Fw, k = 8, 64, 32, 2
    x = torch.randn(tokens, H, generator=g)
    raw = {"e_gate": torch.randn(E, H, Fw, generator=g) / 8,
           "e_up": torch.randn(E, H, Fw, generator=g) / 8,
           "e_down": torch.randn(E, Fw, H, generator=g) / 6}
    q = dec.quantize_decoder_params(raw)
    deq = {n: q[n]["q"].float() * q[n]["s"][:, None, :] for n in q}
    router = (torch.randn(H, E, generator=g) / 8).to(torch.bfloat16)
    cfg = dataclasses.replace(drv.decoder_config(CFG))
    w, ids = moe.router(x, router, cfg)
    got = omoe.moe_experts(x, ids, w, q["e_gate"], q["e_up"], q["e_down"])
    want = _naive_experts(x, ids, w, deq["e_gate"], deq["e_up"],
                          deq["e_down"])
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    _, ids16 = moe.router(x.to(torch.bfloat16), router, cfg)
    agree = float((ids16.sort(-1).values == ids.sort(-1).values).all(-1)
                  .float().mean())
    assert agree >= 0.9, agree


def test_expert_kernel_wrapper_refuses_rather_than_falls_back_off_the_cpu():
    """Off the CPU `moe_experts` takes only what csrc/moe_experts.cu
    takes: non-bf16 activations or a float weight raise TypeError (never
    a per-expert loop that reads counts back to the host), widths off the
    kernel's 64-column tiles a ValueError. Meta tensors stand in for the
    card's: the wrapper refuses before it touches any data."""
    meta = torch.device("meta")
    E, H, Fw, T, k = 4, 64, 128, 5, 2

    def int8(e, i, o):
        return {"q": torch.empty(e, i, o, dtype=torch.int8, device=meta),
                "s": torch.empty(e, o, device=meta)}

    ids = torch.zeros(T, k, dtype=torch.long, device=meta)
    w = torch.empty(T, k, device=meta)
    x = torch.empty(T, H, dtype=torch.bfloat16, device=meta)
    good = (int8(E, H, Fw), int8(E, H, Fw), int8(E, Fw, H))
    assert omoe.check_kernel_inputs(x, ids, *good) == (E, H, Fw)
    with pytest.raises(TypeError, match="bf16 activations"):
        omoe.moe_experts(x.float(), ids, w, *good)
    floats = (torch.empty(E, H, Fw, device=meta),
              torch.empty(E, H, Fw, device=meta),
              torch.empty(E, Fw, H, device=meta))
    with pytest.raises(TypeError, match="int8 codes"):
        omoe.moe_experts(x, ids, w, *floats)
    with pytest.raises(TypeError, match="int8 codes"):
        omoe.moe_experts(x, ids, w, good[0], good[1], floats[2])
    with pytest.raises(ValueError, match="multiples of 64"):
        omoe.moe_experts(x, ids, w, int8(E, H, 96), int8(E, H, 96),
                         int8(E, 96, H))


def test_align_places_every_pair_once_in_single_expert_blocks():
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 8, (37, 3), generator=g)
    for block in (16, 64):
        sp, bexp, pos, counts = omoe.align(ids, 8, block)
        P = ids.numel()
        assert sp.shape[0] % block == 0
        assert sp.shape[0] >= P + 8 * (block - 1)
        assert sorted(sp[sp < P].tolist()) == list(range(P))
        assert torch.equal(sp[pos], torch.arange(P))
        assert counts.tolist() == torch.bincount(ids.reshape(-1),
                                                 minlength=8).tolist()
        flat = ids.reshape(-1)
        for b, e in enumerate(bexp.tolist()):
            rows = sp[b * block:(b + 1) * block]
            real = rows[rows < P]
            if e < 0:
                assert real.numel() == 0
            else:
                assert (flat[real] == e).all()


def test_yarn_frequencies_and_softmax_scale_by_the_formula():
    """DeepSeek-V2-Lite's rope: dims 64, theta 1e4, factor 40 over 4,096,
    beta 32 / 1 -> correction range (10, 23) by hand (64 ln(4096 / 2 pi
    32) / 2 ln 1e4 = 10.47, 64 ln(4096 / 2 pi) / 2 ln 1e4 = 22.5); the
    softmax scale 192^-0.5 (0.1 * 0.707 * ln 40 + 1)^2 = 0.11473."""
    lite = dataclasses.replace(
        drv.decoder_config(CFG), qk_nope_head_dim=128, qk_rope_head_dim=64,
        rope_original_max_len=4096)
    assert mla.yarn_correction_range(lite, 64) == (10, 23)
    inv = mla.inv_freq(lite)
    base = 1e4 ** (torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    assert torch.allclose(inv[:10].double(), 1 / base[:10], rtol=1e-6)
    assert torch.allclose(inv[23:].double(), 1 / (40 * base[23:]),
                          rtol=1e-6)
    ramp = (torch.arange(10, 23, dtype=torch.float64) - 10) / 13
    mid = (1 / (40 * base[10:23])) * ramp + (1 / base[10:23]) * (1 - ramp)
    assert torch.allclose(inv[10:23].double(), mid, rtol=1e-6)
    want = 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2
    assert mla.softmax_scale(lite) == pytest.approx(want, rel=1e-12)
    assert mla.softmax_scale(lite) == pytest.approx(0.11473, abs=1e-5)
    assert mla.cos_sin_factor(lite) == 1.0
    assert mla.cos_sin_factor(dataclasses.replace(
        lite, rope_mscale=1.0)) == pytest.approx(
        (0.1 * math.log(40) + 1) / (0.1 * 0.707 * math.log(40) + 1))
    # the reference computes the same frequencies on its own
    refc = dict(CFG, qk_rope_head_dim=64, rope_scaling=dict(
        CFG["rope_scaling"], original_max_position_embeddings=4096))
    assert torch.allclose(inv.double(), ref.inv_freq(refc), rtol=1e-6)
    assert ref.softmax_scale(dict(refc, qk_nope_head_dim=128)) == \
        pytest.approx(want, rel=1e-12)


def test_rope_pairs_adjacent_dims():
    """DeepSeek's pairing: dims (2i, 2i+1) rotate together by frequency
    i; the output is in rotate-half order."""
    cfg = drv.decoder_config(CFG)
    x = torch.zeros(1, 1, 1, 16)
    x[..., 2], x[..., 3] = 1.0, 0.0  # pair 1 = (1, 0)
    cos, sin = mla.rope_tables(torch.tensor([[7]]), cfg,
                               mla.inv_freq_on(cfg, CPU))
    y = mla.apply_rope(x, cos, sin)[0, 0, 0]
    ang = 7 * float(mla.inv_freq(cfg)[1])
    assert float(y[1]) == pytest.approx(math.cos(ang), abs=1e-6)
    assert float(y[9]) == pytest.approx(math.sin(ang), abs=1e-6)
    assert float(y.abs().sum()) == pytest.approx(
        abs(math.cos(ang)) + abs(math.sin(ang)), abs=1e-6)


def _greedy_solo(params, cfg, prompt, max_new, pad):
    ids = np.zeros((1, pad), np.int32)
    ids[0, :len(prompt)] = prompt
    out, _ = dec.generate(params, cfg, ids, np.asarray([len(prompt)]),
                          max_new, -1, -7)
    return [int(t) for t in out[0] if int(t) != -7]


def test_batcher_with_prefix_and_compaction_matches_solo_generate():
    """Greedy requests through `ContinuousBatcher`: a registered prefix,
    rows joining and leaving, a forced compaction (the horizon is
    shorter than the tokens), every T = 1 step through the kernel's
    plain version: the tokens of a solo `generate` each (f32 activations,
    int8 latent cache: batching changes no arithmetic)."""
    cfg_d = _cfg(kv_int8=True, attn_kernel=True)
    params, cfg = _model(cfg_d)
    rng = np.random.default_rng(9)
    header = [int(t) for t in rng.integers(3, 211, 11)]
    prompts = [header + [int(t) for t in rng.integers(3, 211, n)]
               for n in (3, 6, 1)] + [[int(t) for t in
                                       rng.integers(3, 211, 7)]]
    before = da.decode_attend_int8
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return before(*a, **k)

    async def run():
        b = ContinuousBatcher(params, cfg, slots=2, prompt_pad=32,
                              horizon=32, chunk=4)
        b.register_prefix(header)
        outs = await asyncio.gather(*[b.submit(p, max_new=20)
                                      for p in prompts])
        return outs, b

    da.decode_attend_int8 = counted
    try:
        got, b = asyncio.run(run())
    finally:
        da.decode_attend_int8 = before
    assert b.compactions > 0 and b.prefix_hits == 3
    assert len(calls) == cfg.num_layers * b.steps
    stats = b.stats()
    assert stats["moe_routed_pairs"] > 0 and stats["moe_experts_hit"] > 0
    text = METRICS.render()
    assert "moe_routed_pairs_total" in text
    assert "moe_experts_hit_total" in text
    for p, toks in zip(prompts, got):
        assert toks == _greedy_solo(params, cfg, p, 20, 32), p


def test_counters_count_pairs_and_experts():
    params, cfg = _model(CFG)
    pairs0, hits0 = moe.routed_pairs(), moe.experts_hit(wait=True)
    _prefill_logits(params, cfg, IDS[:10])
    # 2 expert layers x 10 tokens x top-2
    assert moe.routed_pairs() - pairs0 == 2 * 10 * 2
    hit = moe.experts_hit(wait=True) - hits0
    assert 2 <= hit <= 2 * 8


def test_kernel_gate_admits_the_latent_geometry_only_on_its_limits():
    # DeepSeek-V2-Lite: one kv head of 576 under 16 query heads, S 4,608
    assert da.kernel_fits(seq_len=4608, head_dim=576, q_groups=16)
    assert not da.supported(seq_len=4608, kv_heads=1, head_dim=576)
    assert not da.kernel_fits(seq_len=4600, head_dim=576, q_groups=16)
    assert not da.kernel_fits(seq_len=4608, head_dim=1040, q_groups=16)
    # Mistral keeps the JAX tiling gate
    assert da.supported(seq_len=4608, kv_heads=8, head_dim=128)


def test_convert_hf_state_dict_loads_the_reference_weights():
    """A `modeling_deepseek`-layout state dict ((out, in) linears,
    kv_b_proj per head [nope; v], experts by index) built from the
    reference's dequantized weights converts to a tree whose f32
    forward gives the reference's logits (the order of f32 sums only)."""
    w = ref.Weights(SEED, CFG, CPU)
    top = w.layer(-1)
    sd = {"model.embed_tokens.weight": top["embed"],
          "lm_head.weight": top["lm_head"].T,
          "model.norm.weight": torch.ones(64)}
    for i in range(3):
        lw = w.layer(i)
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = torch.ones(64)
        sd[pre + "post_attention_layernorm.weight"] = torch.ones(64)
        sd[pre + "self_attn.kv_a_layernorm.weight"] = torch.ones(32)
        for name in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
            sd[pre + f"self_attn.{name}.weight"] = lw[name].T
        if i == 0:
            for name in ("gate_proj", "up_proj", "down_proj"):
                sd[pre + f"mlp.{name}.weight"] = lw[name].T
        else:
            sd[pre + "mlp.gate.weight"] = lw["gate"].T
            for name in ("gate_proj", "up_proj", "down_proj"):
                for e in range(8):
                    sd[pre + f"mlp.experts.{e}.{name}.weight"] = \
                        lw["experts." + name][e].T
                sd[pre + f"mlp.shared_experts.{name}.weight"] = \
                    lw["shared." + name].T
    cfg = dataclasses.replace(drv.decoder_config(CFG))
    params = dec.convert_hf_deepseek_v2_state_dict(sd, cfg, device="cpu")
    assert set(params) == set(dec.latent_shapes(cfg)) | {
        "attn_norm", "ffn_norm", "kva_norm", "final_norm"}
    for name, (shape, _) in dec.latent_shapes(cfg).items():
        assert params[name].shape == shape, name
    got = _prefill_logits(params, cfg, IDS)
    assert torch.allclose(got, _ref_logits(), atol=1e-4, rtol=1e-4)


def test_init_decoder_params_and_quantization_keep_the_router():
    cfg = drv.decoder_config(CFG)
    p = dec.init_decoder_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    q = dec.quantize_decoder_params(p)
    assert isinstance(q["router"], torch.Tensor)
    assert q["e_gate"]["q"].shape == (2, 8, 64, 32)
    assert q["e_gate"]["s"].shape == (2, 8, 32)
    assert q["w_uk"]["q"].shape == (3, 32, 64)
    assert isinstance(q["kva_norm"], torch.Tensor)
    assert torch.isfinite(_prefill_logits(q, cfg, IDS[:8])).all()


def test_out_of_scope_paths_raise_value_errors():
    params, cfg = _model(_cfg(kv_int8=True))
    with pytest.raises(ValueError, match="speculative"):
        ContinuousBatcher(params, cfg, slots=1, prompt_pad=16, horizon=16,
                          chunk=2, spec_k=2)
    with pytest.raises(ValueError, match="LoRA"):
        ContinuousBatcher(params, cfg, slots=1, prompt_pad=16, horizon=16,
                          chunk=2, lora_banks={})
    ck, cv = dec.init_kv_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="LoRA"):
        dec.forward(params, cfg, torch.tensor([[5, 6]]),
                    torch.arange(2)[None], ck, cv,
                    lora={"aid": [0], "banks": {}})
    from rag_application_tpu_torch.models.speculative import generate_lookup

    with pytest.raises(ValueError, match="speculative"):
        generate_lookup(params, cfg, np.asarray([[5, 6, 7]]),
                        np.asarray([3]), 4, -1, -7)
    from rag_application_tpu_torch.parallel import tp
    from rag_application_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="tensor parallelism"):
        tp.shard_params(make_mesh(2, model=2, devices=["cpu"] * 2), params)
    fcfg = dataclasses.replace(cfg, kv_quant=False)
    train = {k: (v.float().requires_grad_() if k == "wq" else v)
             for k, v in dec.init_decoder_params(
                 torch.Generator().manual_seed(0), fcfg,
                 device="cpu").items()}
    ck, cv = dec.init_kv_cache(fcfg, 1, 2, device="cpu")
    with torch.enable_grad(), pytest.raises(ValueError, match="training"):
        dec.forward(train, fcfg, torch.tensor([[5, 6]]),
                    torch.arange(2)[None], ck, cv)
