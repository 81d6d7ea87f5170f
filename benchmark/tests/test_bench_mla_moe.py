"""The DeepSeek-V2-Lite cell on the CPU at a tiny size of the same kinds
(3 layers, the first dense, hidden 64, 4 heads, kv_lora_rank 32, 8
experts top-2 and 1 shared, YaRN): through its driver, a sound run reads
correct, the int4 control and a run with the shared experts left out of
the expert layer read not correct; the counts of `roofline_moe` against
hand counts; the two new readers on hand-built spans and the spans a
traced run leaves."""

import copy
import time

import pytest
import torch

from benchmark import harness, roofline_moe
from benchmark.reference import deepseek_v2 as ref
from benchmark.tests import test_bench_contract as contract
from benchmark.tests.test_bench_spans import _readings, _span
from rag_application_tpu_torch.models import decoder as dec

from .conftest import SEED

CPU = torch.device("cpu")
CELL = "deepseek-v2-lite.rag-answers-64"
TINY = {"vocab_size": 211, "hidden_size": 64, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 96, "max_position_embeddings": 4096,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
        "v_head_dim": 16, "n_routed_experts": 8, "n_shared_experts": 1,
        "moe_intermediate_size": 32, "num_experts_per_tok": 2,
        "rope_scaling": {"type": "yarn", "factor": 40,
                         "original_max_position_embeddings": 32,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707}}
# between the tiny cell's sound reading (0.70 at SEED) and its int4
# control (2.49): the cell's own limit is set from card readings
TINY_LIMIT = 1.2


def tiny_cell() -> harness.Cell:
    cell = harness.find_cell(CELL)
    cell.config = dict(copy.deepcopy(cell.config), **copy.deepcopy(TINY))
    cell.mix = dict(cell.mix, clients=4, per_client=4, system_tokens=16,
                    context_tokens=[32, 96], question_tokens=[4, 8],
                    new_tokens=[8, 16], judged_requests=3,
                    batcher={"slots": 4, "prompt_pad": 128, "horizon": 256,
                             "chunk": 4}, trace_seconds=0.5,
                    limits={"served_logit_gap": TINY_LIMIT})
    return cell


def _run(cell, trace=False, fault=None, seconds=0.5):
    out, _ = harness.driver_for(cell).run(cell, SEED, seconds, trace, CPU,
                                          time.perf_counter(), fault=fault)
    return out


def test_the_cell_keeps_its_published_widths():
    cell = harness.find_cell(CELL)
    cfg = cell.config
    assert cfg["reduced"] == [] and cfg["num_hidden_layers"] == 27
    assert (cfg["hidden_size"], cfg["kv_lora_rank"], cfg["n_routed_experts"],
            cfg["moe_intermediate_size"]) == (2048, 512, 64, 1408)
    assert cell.mix["driver"] == "generate_mla_moe"
    assert {m["name"] for m in cell.per_layer} == {
        "ttft_p95_ms", "tokens_per_step", "gen_mfu", "decode_attn_roofline",
        "device_idle_share.gen", "moe_roofline", "mla_decode_roofline"}
    assert [m["name"] for m in cell.end_to_end] == ["gen_tokens_s",
                                                    "setup_s"]


def test_sound_run_reads_correct_and_the_control_does_not():
    cell = tiny_cell()
    out = _run(cell)
    assert out.correct and out.failed == 0 and out.judged
    control = harness.driver_for(cell).judge(cell.config, SEED, out.judged,
                                             CPU, bits=4)
    assert control > TINY_LIMIT > out.checks[0][1]


def test_experts_without_the_shared_ones_read_not_correct(monkeypatch):
    from rag_application_tpu_torch.models import moe

    real = moe.layer

    def no_shared(h, lp, cfg):
        return real(h, {k: v for k, v in lp.items()
                        if not k.startswith("s_")}, cfg)

    monkeypatch.setattr(moe, "layer", no_shared)
    out = _run(tiny_cell())
    assert not out.correct, out.checks
    assert out.checks[0][1] > 2 * TINY_LIMIT


def test_the_port_tree_holds_the_references_weights():
    """W_uk and W_uv, split from the drawn kv_b_proj by head, and an
    expert, dequantized, equal the reference's int8 weights."""
    cell = tiny_cell()
    drv = harness.driver_for(cell)
    cfg = dict(cell.config, serving=dict(cell.config["serving"]))
    params = drv.build_params(cfg, SEED, CPU)
    lw = ref.Weights(SEED, cfg, CPU).layer(2)

    def deq(leaf, i):
        q, s = params[leaf]["q"][i], params[leaf]["s"][i]
        return q.float() * s.unsqueeze(-2)

    kvb = lw["kv_b_proj"].view(32, 4, 32)
    assert torch.equal(deq("w_uk", 2), kvb[..., :16].reshape(32, 64))
    assert torch.equal(deq("w_uv", 2), kvb[..., 16:].reshape(32, 64))
    assert torch.equal(deq("e_down", 1)[5], lw["experts.down_proj"][5])
    assert torch.equal(params["router"][1].float(), lw["gate"])


W = roofline_moe.widths(dict(TINY, intermediate_size=96,
                             first_k_dense_replace=1))


def test_expert_work_by_hand():
    # 3 tokens, 5 experts reached: 3 x (2 routed x 3 x 64 x 32 + shared
    # 3 x 64 x 32 + router 64 x 8) multiply-adds
    ops, nbytes = roofline_moe.moe_work(W, 3, 5)
    assert ops == 2 * 3 * (2 * 3 * 64 * 32 + 3 * 64 * 32 + 64 * 8)
    # an expert: 3 x 64 x 32 int8 codes, (32 + 32 + 64) f32 scales; the
    # shared one the same; the bf16 router; 3 tokens in and out in bf16
    expert = 3 * 64 * 32 + 4 * (32 + 32 + 64)
    assert nbytes == 5 * expert + expert + 2 * 64 * 8 + 2 * 2 * 3 * 64


def test_latent_decode_work_by_hand():
    # 2 rows over 10 latents in all: absorb 4 x 16 x 32, W_uv 4 x 32 x 16
    # a row; scores 4 x 48 and values 4 x 32 a latent
    ops, nbytes = roofline_moe.mla_decode_work(W, 2, 10)
    assert ops == 2 * (2 * 4 * (16 * 32 + 32 * 16) + 10 * 4 * (48 + 32))
    # latents 48 B + a 4-B scale; W_uk, W_uv codes and f32 scales; q (16 +
    # 16 a head) and out (16 a head) in bf16
    want = (10 * 52 + 32 * 4 * 32 + 4 * 4 * 32 + 2 * 4 * (16 + 16 + 16) * 2)
    assert nbytes == want


def test_model_flops_by_hand():
    cfg = dict(TINY, intermediate_size=96, first_k_dense_replace=1,
               num_hidden_layers=3)
    # a layer's projections: W_q 64 x 128, W_kva 64 x 48, W_o 64 x 64
    proj = 64 * 128 + 64 * 48 + 64 * 64
    mlp = 3 * 64 * 96 + 2 * (64 * 8 + 2 * 3 * 64 * 32 + 3 * 64 * 32)
    # decode at position 9 (10 latents): absorb + W_uv, scores 48 and
    # values 32 wide a latent and head
    attn = 4 * (16 * 32 + 32 * 16) + 4 * (48 + 32) * 10
    assert roofline_moe.token_flops(cfg, 9, False) == 2 * (
        3 * (proj + attn) + mlp)
    assert roofline_moe.token_flops(cfg, 9, True) == 2 * (
        3 * (proj + attn) + mlp) + 2 * 64 * 211
    # a prefill of 2 tokens after 3 cached: 5 latents expanded (nope + v),
    # scores 32 and values 16 wide over 4 + 5 visible slots
    expand = 5 * 32 * 4 * 32
    span = 4 + 5
    want = 2 * (2 * (3 * proj + mlp) + 3 * (expand + 4 * 48 * span)) \
        + 2 * 64 * 211
    assert roofline_moe.prefill_flops(cfg, 3, 2) == want


@pytest.fixture
def session(monkeypatch):
    from benchmark import spans

    box = []
    monkeypatch.setattr(spans, "session", lambda: list(box))
    return box


def _read(name, r):
    return harness.metric_reader(name).read(r)


def test_readers_on_hand_built_spans(session):
    session += [
        _span(0, "model.moe", 0.1, 0.2, device_ms=2.0, layer=1, tokens=3,
              experts=torch.tensor(5)),
        _span(1, "model.moe", 0.3, 0.4, device_ms=4.0, layer=2, tokens=3,
              experts=torch.tensor(5)),
        _span(2, "model.moe", -0.2, -0.1, device_ms=1.0, tokens=3,
              experts=torch.tensor(5)),  # before the stretch: out
        _span(3, "model.mla", 0.1, 0.2, device_ms=1.0, path="decode",
              tokens=2, slots=torch.tensor(10)),
        _span(4, "model.mla", 0.3, 0.4, device_ms=9.0, path="prefill",
              tokens=40, slots=None),
    ]
    r = _readings(session, 1.0)
    r.work = {"deepseek": W}
    one = roofline_moe.bound_s(roofline_moe.moe_work(W, 3, 5),
                               roofline_moe.PEAK_BF16_FLOPS)
    assert _read("moe_roofline", r) == pytest.approx(
        100 * 2 * one / 6e-3)
    dec_bound = roofline_moe.bound_s(roofline_moe.mla_decode_work(W, 2, 10),
                                     roofline_moe.PEAK_BF16_FLOPS)
    assert _read("mla_decode_roofline", r) == pytest.approx(
        100 * dec_bound / 1e-3)
    # nothing to read without the widths, the spans or a stretch
    r.work = {}
    assert _read("moe_roofline", r) is None
    assert _read("mla_decode_roofline", harness.Readings(
        work={"deepseek": W})) is None
    del session[:]
    r = _readings([], 1.0)
    r.work = {"deepseek": W}
    assert _read("moe_roofline", r) is None


def test_a_traced_run_leaves_the_spans_the_readers_read():
    """On the CPU the spans carry no device time (no CUDA events), so the
    readers read nothing here; their spans, with the attributes the
    readers take, are in the session of the traced stretch."""
    from benchmark import spans

    # a longer window than the calibrated runs': a traced stretch on a
    # busy host can otherwise finish no request to judge
    out = _run(tiny_cell(), trace=True, seconds=2.0)
    assert out.correct and out.readings.trace is not None
    got = spans.placed(out.readings, ("model.moe", "model.mla"))
    moe = [s for s, _, _ in got if s.name == "model.moe"]
    mla = [s for s, _, _ in got if s.name == "model.mla"
           and s.attrs["path"] == "decode"]
    # a step begun before tracing turned on has no visible count
    counted = [s for s in mla if s.attrs["slots"] is not None]
    assert moe and counted
    assert all(1 <= int(s.attrs["experts"]) <= 8 for s in moe)
    assert all(s.attrs["tokens"] == 4 and int(s.attrs["slots"]) >= 1
               for s in counted)
    assert out.readings.work["model_flops"] > 0


def test_the_new_entries_keep_the_form_of_benchmark_json():
    contract.test_metrics()
    contract.test_workloads()
    contract.test_configs_files_and_reduced()
    for name in ("moe_roofline", "mla_decode_roofline"):
        assert harness.metric_reader(name).UNIT == "%"


def test_the_latent_tree_quantizes_as_the_driver_writes_it():
    cell = tiny_cell()
    dcfg = harness.driver_for(cell).decoder_config(cell.config)
    shapes = dec.latent_shapes(dcfg)
    assert shapes["e_gate"][0] == (2, 8, 64, 32)
    assert shapes["router"][0] == (2, 64, 8)
    assert dcfg.latent and dcfg.dense_layers == 1


def test_a_run_of_the_driver_loads_no_jax():
    """The tiny cell end to end in a process of its own: what the driver,
    the reference and the port load holds no forbidden name."""
    import json
    import os
    import subprocess
    import sys

    code = """
import sys, time, json
sys.path.insert(0, %r)
import torch
from benchmark import harness
from benchmark.tests.test_bench_mla_moe import tiny_cell
cell = tiny_cell()
out, _ = harness.driver_for(cell).run(cell, 2 ** 31 + 5, 2.0, False,
                                      torch.device("cpu"), time.perf_counter())
assert out.correct, out.checks
print(json.dumps(harness.forbidden_modules()))
""" % harness.ROOT
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT,
                         env=dict(os.environ, USE_JAX="0"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
