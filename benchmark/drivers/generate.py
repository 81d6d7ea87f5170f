"""Closed-loop clients of the port's continuous batcher: the batcher that
`LocalLLM.enable_batching` returns, driven through `submit_stream`.

The configuration is a decoder's published `config.json` with the serving
precision it states; the mix gives the clients, the batcher's settings
and the request sizes: a shared system prompt (registered as the cached
prefix), a retrieved context and a question, and a number of new tokens,
greedy and with no end-of-sequence token. Weights and prompt tokens are
made from the seed, the weights on the card in one call a leaf.

Every client starts during set-up; the window opens with the delivery
that brings the last client its first token, and closes with the first
delivery past ``--seconds``: tokens come a decode chunk at a time, so
the window holds whole chunks. Tokens delivered inside it count. When it closes,
the clients and the batcher are stopped, and the plain reference
(benchmark/reference/decoder.py) teacher-forces a seeded sample of the
requests finished in the window, the longest among them, and reads how
far each served token's logit lies below its best.
"""

from __future__ import annotations

import asyncio
import gc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from benchmark import data, harness
from benchmark.reference import decoder as ref


@dataclass
class Request:
    client: int
    prompt: List[int]
    new: int
    t_submit: float
    tokens: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)
    t_done: Optional[float] = None
    error: Optional[str] = None


def decoder_config(cfg: Dict[str, Any]):
    from rag_application_tpu_torch.models.decoder import DecoderConfig

    s = cfg["serving"]
    return DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        heads=cfg["num_attention_heads"],
        kv_heads=cfg["num_key_value_heads"],
        mlp_dim=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), eps=float(cfg["rms_norm_eps"]),
        dtype=s["dtype"], kv_quant=s["kv_int8"],
        attn_kernel=s["attn_kernel"])


def build_params(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The seed's weights, quantized by the port one leaf at a time."""
    from rag_application_tpu_torch.models.decoder import (
        quantize_decoder_params)

    params: Dict[str, Any] = {}
    for name in data.DECODER_LEAVES:
        w = data.decoder_leaf(seed, cfg, name, device)
        if cfg["serving"]["weights_int8"]:
            params.update(quantize_decoder_params({name: w}))
        else:
            params[name] = w
        del w
    L, H = cfg["num_hidden_layers"], cfg["hidden_size"]
    for name, shape in (("attn_norm", (L, H)), ("ffn_norm", (L, H)),
                        ("final_norm", (H,))):
        params[name] = torch.ones(shape, dtype=torch.bfloat16,
                                  device=device)
    return params


def _prompt(seed: int, cfg, system: List[int], client: int, i: int,
            spec: Dict[str, int]) -> List[int]:
    body = data.prompt_tokens(seed, 1000 + client * 4096 + i,
                              spec["context"] + spec["question"],
                              cfg["vocab_size"])
    return system + body


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None):
    """One run of the cell. ``fault``, a test's hook, may break the
    batcher before the clients start (the run must then read not
    correct)."""
    cfg, mix = cell.config, cell.mix
    torch.set_grad_enabled(False)
    from rag_application_tpu_torch.llm.local import LocalLLM

    dcfg = decoder_config(cfg)
    # clients send token ids: no tokenizer
    llm = LocalLLM(build_params(cfg, seed, device), dcfg, None,
                   eos_id=cfg["eos_token_id"], device=device)
    b = mix["batcher"]
    batcher = llm.enable_batching(
        slots=b["slots"], prompt_pad=b["prompt_pad"], horizon=b["horizon"],
        chunk=b["chunk"], temperature=0.0)
    if fault is not None:
        fault(batcher)
    system = data.prompt_tokens(seed, 12, mix["system_tokens"],
                                cfg["vocab_size"])
    batcher.register_prefix(system)
    specs = data.request_mix(seed, mix["clients"], mix["per_client"], mix)
    state = asyncio.run(_serve(cell, seed, seconds, trace, device, batcher,
                               system, specs, t_start))
    (reqs, w0, w1, stats0, stats1, prof, t_trace, traced_steps,
     setup_s) = state
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    done = [r for r in reqs if r.t_done is not None and w0 < r.t_done <= w1]
    sent = [r for r in reqs if w0 < r.t_submit <= w1]
    failed = sum(1 for r in sent if r.error is not None) + sum(
        1 for r in done if len(r.tokens) != r.new)
    delivered = sum(1 for r in reqs for t in r.times if w0 < t <= w1)
    window = w1 - w0
    # a request sent in the window and still without its first token at
    # the close counts as waiting from submit to the close (a censored
    # time, below its true one), so the slow ones stay in the tail
    first = [r.times[0] for r in sent if r.times and r.times[0] <= w1]
    ttft = [(r.times[0] if r.times and r.times[0] <= w1 else w1)
            - r.t_submit for r in sent]
    readings = harness.Readings(
        spans={"ttft": ttft},
        counters={k: stats1[k] - stats0[k] for k in ("steps", "tokens_out")},
        work=_work(cfg, mix, reqs, w0, w1, t_trace))
    if prof is not None:
        readings.trace = harness.Trace.from_profiler(
            prof, t_trace[1] - t_trace[0])

    del llm, batcher
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = pick(seed, done, mix["judged_requests"])
    gap = judge(cfg, seed, sample, device)
    checks = [("served_logit_gap", gap, mix["limits"]["served_logit_gap"])]
    correct = failed == 0 and bool(done) and all(
        v <= lim for _, v, lim in checks)
    e2e = {"gen_tokens_s": delivered / window}
    notes = {"window_s": window, "sent": len(sent), "done": len(done),
             "delivered": delivered, "ttft_n": len(ttft),
             "ttft_censored": len(ttft) - len(first),
             **readings.counters,
             "compactions": stats1.get("compactions", 0),
             "traced_s": t_trace[1] - t_trace[0],
             "traced_steps": traced_steps,
             "errors": sorted({r.error for r in reqs if r.error})[:3]}
    return harness.Outcome(e2e, readings, checks, correct, len(sent),
                           failed, peak, notes, sample), setup_s


async def _serve(cell, seed, seconds, trace, device, batcher, system,
                 specs, t_start):
    cfg, mix = cell.config, cell.mix
    reqs: List[Request] = []
    closed = asyncio.Event()

    async def one(client: int, prompt: List[int], new: int) -> Request:
        r = Request(client, prompt, new, time.perf_counter())
        reqs.append(r)
        try:
            async for t in batcher.submit_stream(prompt, max_new=new):
                r.times.append(time.perf_counter())
                r.tokens.append(int(t))
            r.t_done = time.perf_counter()
        except Exception as exc:  # a failed request is counted, not fatal
            r.error = repr(exc)
        return r

    # warm-up: the two suffix buckets a prompt of this mix pads to, as
    # one more client's requests
    lo, hi = mix["context_tokens"]
    extra = len(specs)
    await asyncio.gather(*[
        one(extra, _prompt(seed, cfg, system, extra, i,
                           {"context": c,
                            "question": mix["question_tokens"][0]}),
            2 * mix["batcher"]["chunk"])
        for i, c in enumerate((lo, hi))])
    reqs.clear()
    if trace:
        harness.warm_profiler(device)

    async def client(c: int) -> None:
        i = 0
        while not closed.is_set():
            spec = specs[c][i % len(specs[c])]
            r = await one(c, _prompt(seed, cfg, system, c, i, spec),
                          spec["new"])
            i += 1
            if r.error is not None:
                return

    tasks = [asyncio.create_task(client(c)) for c in range(len(specs))]

    async def first_tokens() -> float:
        """When every client has its first token: the end of the decode
        chunk that delivered the last of them."""
        while not all(any(r.client == c and r.times for r in reqs)
                      for c in range(len(specs))):
            await asyncio.sleep(0.002)
        return max(r.times[-1] for r in reqs if r.times)

    # the window opens and closes on deliveries: tokens come a decode
    # chunk (`chunk` steps of every row) at a time, so each end sits at
    # the end of a chunk's delivery and the window holds whole chunks
    w0 = await first_tokens()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = w0 - t_start
    stats0 = dict(batcher.stats())
    prof, t_trace, traced_steps = None, [0.0, 0.0], [0]
    if trace:
        lead = max(0.0, (seconds - mix["trace_seconds"]) / 2)
        await asyncio.sleep(max(0.0, w0 + lead - time.perf_counter()))
        prof = harness.profiler(device)
        prof.__enter__()
        t_trace[0] = time.perf_counter()
        steps_at = batcher.stats()["steps"]
        await asyncio.sleep(min(mix["trace_seconds"], seconds))
        # admissions stop every row, and a burst of them can outlast the
        # stretch: it runs on until two decode chunks were dispatched in
        # it (the first may have launched part of its kernels before the
        # start), so the decode kernel has whole calls to read
        while batcher.stats()["steps"] < steps_at + 2 * batcher.chunk \
                and time.perf_counter() < w0 + seconds:
            await asyncio.sleep(0.002)
        traced_steps[0] = batcher.stats()["steps"] - steps_at
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_trace[1] = time.perf_counter()
        prof.__exit__(None, None, None)
    deadline = w0 + seconds
    await asyncio.sleep(max(0.0, deadline - time.perf_counter()))
    while max(r.times[-1] for r in reqs if r.times) < deadline \
            and time.perf_counter() < deadline + 120:
        await asyncio.sleep(0.002)
    await asyncio.sleep(0.02)  # the rest of that chunk's deliveries
    w1 = max(r.times[-1] for r in reqs if r.times)
    stats1 = dict(batcher.stats())
    closed.set()
    # stop the clients and the batcher's loop; requests still in flight
    # are abandoned, the executor threads end with asyncio.run
    me = asyncio.current_task()
    rest = [t for t in asyncio.all_tasks() if t is not me]
    for t in rest:
        t.cancel()
    await asyncio.gather(*rest, return_exceptions=True)
    del tasks
    return (reqs, w0, w1, stats0, stats1, prof, t_trace, traced_steps[0],
            setup_s)


def _work(cfg, mix, reqs: List[Request], w0: float, w1: float,
          t_trace) -> Dict[str, Any]:
    """The window's work for the per-layer readers: model operations of
    the tokens delivered in it and of the prompts first answered in it,
    and the visible context of each request live in the traced stretch."""
    from benchmark import roofline

    p0 = mix["system_tokens"]
    flops = 0.0
    for r in reqs:
        plen = len(r.prompt)
        for j, t in enumerate(r.times):
            if w0 < t <= w1:
                if j == 0:
                    flops += roofline.prefill_flops(cfg, p0, plen - p0)
                else:
                    flops += roofline.decoder_token_flops(
                        cfg, plen + j - 1, True)
    mid = (t_trace[0] + t_trace[1]) / 2
    live = [len(r.prompt) + sum(1 for t in r.times if t <= mid)
            for r in reqs if r.times and r.times[0] <= mid
            and (r.t_done is None or r.t_done > mid)]
    return {"model_flops": flops, "window_s": w1 - w0, "live_context": live,
            "kv_heads": cfg["num_key_value_heads"],
            "groups": cfg["num_attention_heads"]
            // cfg["num_key_value_heads"], "head_dim": cfg["head_dim"],
            "traced": bool(t_trace[1])}


def pick(seed: int, done: List[Request], count: int) -> List[Request]:
    """The longest finished request and ``count`` - 1 more drawn from the
    seed."""
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda i: -(len(done[i].prompt) + len(done[i].tokens)))
    rest = order[1:]
    r = data.rng(seed, 30)
    extra = r.choice(len(rest), size=min(count - 1, len(rest)),
                     replace=False) if rest else []
    return [done[order[0]]] + [done[rest[i]] for i in extra]


def judge(cfg, seed: int, sample: List[Request], device,
          bits: int = 8) -> float:
    """The widest gap, over the sampled requests' served tokens, by which
    a served token's reference logit lies below the reference's best.
    With ``bits`` 4 the tokens judged are the ones the reference with
    int4 weights puts first instead (the control: one precision step
    below the int8 weights the configuration states), on the same
    prompts and served tokens."""
    if not sample:
        return float("inf")
    weights = ref.Weights(seed, cfg, device, bits=8)
    low = ref.Weights(seed, cfg, device, bits=bits) if bits != 8 else None
    return max(float(ref.served_gaps(weights, r.prompt, r.tokens,
                                     other=low).max()) for r in sample)
