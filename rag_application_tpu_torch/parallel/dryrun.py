"""One short run of every multi-device path at tiny shapes.

Port of `__graft_entry__.py::dryrun_multichip`, on the port's mesh (a
grid of `torch.device`s that may repeat a device, parallel/mesh.py):

  * the encoder's DP x TP contrastive step (`shard_train_setup`);
  * the sharded retrieval funnel and the sharded KG search
    (`sharded_topk_dryrun`, `sharded_kg_dryrun`);
  * TP `generate` over a decoder tree sharded by `tp.shard_params`;
  * the continuous batcher over the same tree with speculative verify
    blocks (``spec_k=2``), a registered prefix and an int8 KV cache;
  * the decoder's DP x TP LM step (`shard_lm_train_setup`).

Run it as ``python -m rag_application_tpu_torch.parallel.dryrun [n]``:
on ``[cuda:0] * n`` (raising when CUDA is absent), or on ``[cpu] * n``
with ``RAGTPU_PLATFORM=cpu``.
"""

from __future__ import annotations

import asyncio
import os
import sys
from dataclasses import replace
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_device
from .mesh import make_mesh


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence[Any]] = None
                     ) -> Dict[str, float]:
    """Build an n-device mesh (2-way tensor parallel when n is even, the
    rest data parallel) over ``devices`` (default: every CUDA device)
    and run each path once; returns the two training losses."""
    from ..config import EncoderConfig
    from ..llm.scheduler import ContinuousBatcher
    from ..models.decoder import DecoderConfig, generate, init_decoder_params
    from ..models.encoder import init_encoder
    from ..models.train import (
        make_optimizer,
        shard_lm_train_setup,
        shard_train_setup,
    )
    from . import tp
    from .kg import sharded_kg_dryrun
    from .search import sharded_topk_dryrun

    model = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, model=model, devices=devices)
    dev = mesh.first

    cfg = EncoderConfig(vocab_size=512, hidden_dim=64, num_layers=2,
                        num_heads=4, mlp_dim=128, max_len=16, out_dim=32)
    enc = init_encoder(cfg, device=dev)
    state, step_fn, _ = shard_train_setup(mesh, enc, make_optimizer(lr=1e-3))
    batch_size = max(8, n_devices * 2)
    rng = np.random.default_rng(0)
    batch = {
        "ids_a": rng.integers(0, 512, (batch_size, 16)).astype(np.int32),
        "mask_a": np.ones((batch_size, 16), bool),
        "ids_b": rng.integers(0, 512, (batch_size, 16)).astype(np.int32),
        "mask_b": np.ones((batch_size, 16), bool),
    }
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    sharded_topk_dryrun(mesh)
    sharded_kg_dryrun(mesh)

    dcfg = DecoderConfig(vocab_size=128, hidden=64, num_layers=2, heads=4,
                         kv_heads=2, mlp_dim=128, max_len=16,
                         dtype="float32")

    def decoder_params(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return init_decoder_params(gen, dcfg, dev)

    dparams = tp.shard_params(mesh, decoder_params(0))
    ids = rng.integers(0, 128, (2, 8)).astype(np.int32)
    out, n_gen = generate(dparams, dcfg, ids, np.asarray([8, 8]), 4, 127, 0)
    if out.shape != (2, 4) or int(n_gen.max()) > 4:
        raise AssertionError(f"generate gave {tuple(out.shape)}")

    qcfg = replace(dcfg, kv_quant=True)

    async def serve_spec():
        b = ContinuousBatcher(dparams, qcfg, slots=2, prompt_pad=8,
                              horizon=32, chunk=2, spec_k=2)
        b.register_prefix([5, 9, 17])
        return await asyncio.gather(b.submit([5, 9, 17, 3], max_new=5),
                                    b.submit([5, 9, 17, 4, 2], max_new=4))

    outs = asyncio.run(serve_spec())
    if [len(o) for o in outs] != [5, 4]:
        raise AssertionError(f"the batcher gave {outs}")

    lm_state, lm_step, _ = shard_lm_train_setup(
        mesh, decoder_params(1), dcfg, make_optimizer(lr=1e-3))
    lm_batch = {"ids": rng.integers(0, 128, (batch_size, 16)).astype(np.int32),
                "mask": np.ones((batch_size, 16), bool)}
    lm_state, lm_m = lm_step(lm_state, lm_batch)
    lm_loss = float(lm_m["loss"])
    if not np.isfinite(lm_loss):
        raise AssertionError(f"non-finite LM loss {lm_loss}")
    if not (tp.replicas_equal(state.params)
            and tp.replicas_equal(lm_state.params)):
        raise AssertionError("data replicas differ after a step")

    print(f"dryrun_multichip OK on {n_devices} devices (mesh {mesh.shape}), "
          f"loss={loss:.4f}, lm_loss={lm_loss:.4f}")
    return {"loss": loss, "lm_loss": lm_loss}


if __name__ == "__main__":
    # RAGTPU_PLATFORM=cpu runs off the card deliberately; unset means
    # the card (as serve.py)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dev = resolve_device(os.environ.get("RAGTPU_PLATFORM") or None)
    dryrun_multichip(n, devices=[dev] * n)
