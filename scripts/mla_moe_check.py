#!/usr/bin/env python3
"""Checks of the DeepSeek-V2 path on the card, at DeepSeek-V2-Lite's
published widths (benchmark/configs/deepseek-v2-lite.json).

    python3 scripts/mla_moe_check.py --sync      # a decode step, no sync
    python3 scripts/mla_moe_check.py --longest   # the longest request

From the root of a checkout, on a machine with the card (the kernels'
checks and times are step 14 of chip_smoke.py, `--latent`). ``--sync``
builds the whole model from a seed and runs one batched decode step's
`forward` (64 rows, S 4,608) under
``torch.cuda.set_sync_debug_mode("error")`` (replayed as CUDA graphs,
held to the cache's first step, which runs the same parts op by op),
with the host's time to dispatch a step and, from a profile of three
replayed steps, its costliest ops. ``--longest`` serves
one request of a 3,584-token prompt (the 256-token registered prefix
and 3,328 more) and 256 new tokens through the continuous batcher, and
holds every logit the batcher sampled from against the plain
reference's full forward over the same tokens: the largest logit gap,
the served-token gap, and the share of (token, layer) expert choices on
which the two agree. Prints one JSON line a phase, with the card's name.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import data, harness  # noqa: E402

CELL = "deepseek-v2-lite.rag-answers-64"


def _ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _model(cell, dev):
    drv = harness.driver_for(cell)
    t0 = time.perf_counter()
    params = drv.build_params(cell.config, 2 ** 31 + 77, dev)
    torch.cuda.synchronize()
    return drv, params, drv.decoder_config(cell.config), \
        time.perf_counter() - t0


def sync_step(cell, dev) -> dict:
    from rag_application_tpu_torch.models import decoder as dec
    from rag_application_tpu_torch.models import latent

    torch.set_grad_enabled(False)
    drv, params, cfg, build_s = _model(cell, dev)
    B, S = 64, 4608
    ck, cv = dec.init_kv_cache(cfg, B, S, device=dev)
    slot_pos = torch.where(torch.arange(S, device=dev) < 2000,
                           torch.arange(S, device=dev), 2 ** 30)[None]
    slot_pos = slot_pos.expand(B, S).int().contiguous()
    tok = torch.randint(3, 1000, (B,), device=dev, dtype=torch.int32)
    pos = torch.full((B,), 2000, device=dev, dtype=torch.int32)

    def step():
        return dec.forward(params, cfg, tok[:, None], pos[:, None], ck, cv,
                           write_slot=2000, slot_positions=slot_pos)[0]

    # a cache's first step runs the parts op by op (and builds every
    # kernel); the second captures them as graphs and replays them
    eager = step()
    graphed = step()
    if not latent._SETS[id(ck["q"])].captured:
        raise AssertionError("the second step did not capture its graphs")
    torch.cuda.synchronize()
    graph_gap = float((graphed.float() - eager.float()).abs().max())
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    top = [[e.key[:60], e.count, e.self_cpu_time_total / 3e3]
           for e in sorted(avg, key=lambda e: -e.self_cpu_time_total)[:12]]
    dev_top = [[e.key[:60], e.count, e.self_device_time_total / 3e3]
               for e in sorted(avg, key=lambda e: -e.self_device_time_total)
               [:20]]
    dev_ms = sum(e.self_device_time_total for e in avg) / 3e3
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        h = step()
        host_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return {"build_s": build_s, "finite": bool(torch.isfinite(h).all()),
            "graph_vs_eager_max": graph_gap,
            "dispatch_ms": host_ms, "host_ms": host,
            "host_top_ms": top, "device_ms": dev_ms,
            "device_top_ms": dev_top, "step_ms": _ms(step, 5),
            "memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def longest(cell, dev) -> dict:
    from benchmark.reference import deepseek_v2 as ref
    from rag_application_tpu_torch.llm import scheduler
    from rag_application_tpu_torch.llm.local import LocalLLM
    from rag_application_tpu_torch.models import moe

    torch.set_grad_enabled(False)
    cfg_j, mix = cell.config, cell.mix
    drv, params, cfg, build_s = _model(cell, dev)
    seed = 2 ** 31 + 77
    system = data.prompt_tokens(seed, 12, mix["system_tokens"],
                                cfg_j["vocab_size"])
    body = data.prompt_tokens(seed, 99, mix["batcher"]["prompt_pad"]
                              - len(system), cfg_j["vocab_size"])
    prompt, new = system + body, 256
    logits, routes = [], []
    real_sample, real_router = scheduler.sample_logits, moe.router

    def keep_logits(lg, *a, **k):
        logits.append(lg[0].float().clone())
        return real_sample(lg, *a, **k)

    def keep_route(h, w, c):
        wts, ids = real_router(h, w, c)
        routes.append(ids.clone())
        return wts, ids

    scheduler.sample_logits, moe.router = keep_logits, keep_route
    try:
        llm = LocalLLM(params, cfg, None, eos_id=cfg_j["eos_token_id"],
                       device=dev)
        b = mix["batcher"]
        batcher = llm.enable_batching(slots=b["slots"],
                                      prompt_pad=b["prompt_pad"],
                                      horizon=b["horizon"], chunk=b["chunk"],
                                      temperature=0.0)
        batcher.register_prefix(system)
        n_prefix = len(routes)
        served = asyncio.run(batcher.submit(prompt, max_new=new))
    finally:
        scheduler.sample_logits, moe.router = real_sample, real_router
    Lm = cfg.num_layers - cfg.dense_layers
    # port choices for each position: the prefix's prefill, the suffix's
    # (its first rows), then row 0 of each decode step
    suffix = len(prompt) - len(system)
    port = [[] for _ in range(Lm)]
    for j, ids in enumerate(routes[:n_prefix]):
        port[j % Lm].append(ids[:len(system)])
    rest = routes[n_prefix:]
    for j, ids in enumerate(rest[:Lm]):
        port[j].append(ids[:suffix])
    for j, ids in enumerate(rest[Lm:]):
        port[j % Lm].append(ids[:1])
    port = [torch.cat(p)[:len(prompt) + new - 1] for p in port]
    del params, llm, batcher
    torch.cuda.empty_cache()
    got = torch.stack(logits[:len(served)])
    seq = prompt + served
    ref_routes = []
    real_route = ref.route

    def keep_ref(c, h, gate):
        w, ids = real_route(c, h, gate)
        ref_routes.append(ids)
        return w, ids

    ref.route = keep_ref
    try:
        want = ref.logits(ref.Weights(seed, cfg_j, dev), seq[:-1],
                          len(prompt) - 1)
    finally:
        ref.route = real_route
    gap = (got - want).abs().max(-1).values
    best = want.max(-1).values
    served_gap = best - want.gather(
        -1, torch.as_tensor(served, device=dev)[:, None])[:, 0]
    agree = []
    for p, r in zip(port, ref_routes):
        n = min(len(p), len(r))
        same = (p[:n].sort(-1).values[:, :, None]
                == r[:n][:, None, :]).any(-1).float().mean(-1)
        agree.append(same)
    agree = torch.cat(agree)
    return {"prompt": len(prompt), "new": len(served), "build_s": build_s,
            "max_logit_gap": float(gap.max()),
            "median_logit_gap": float(gap.median()),
            "max_abs_logit": float(want.abs().max()),
            "served_logit_gap": float(served_gap.max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean()),
            "routing_agreement": float(agree.mean()),
            "routing_all6_same": float((agree == 1).float().mean()),
            "positions_routed": int(len(agree) / max(Lm, 1))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sync", action="store_true")
    ap.add_argument("--longest", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.find_cell(CELL)
    harness.set_environment(cell.root)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    for flag, fn in (("sync", sync_step), ("longest", longest)):
        if getattr(args, flag):
            t0 = time.perf_counter()
            res = fn(cell, dev)
            print(json.dumps({"phase": flag, "card": card,
                              "seconds": time.perf_counter() - t0, **res}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
