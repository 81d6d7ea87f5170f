"""On-device text generation provider.

Port of `rag_application_tpu/llm/local.py`: `LocalLLM` adapts the
port's decoder (models/decoder.py) to the router's chat interface, so
anything that speaks `LLMRouter` can generate on the local card
(`Provider.LOCAL`). Two solo paths, as in the reference:

  * `chat`: `generate` — prefill plus the decode loop for one prompt
    (`speculative=True`: prompt-lookup block verification,
    models/speculative.py);
  * `stream`: a single-token step per yield (time to first token =
    prefill + one step), or, for penalized/biased requests, the
    penalty-aware `generate` streamed by incremental re-detokenization.

Both run the blocking device work in an executor so the serving event
loop stays free. After `enable_batching`, concurrent `chat` and `stream`
calls whose knobs match the batcher's share ONE decode batch
(llm/scheduler.py); with `sampling_ext=True`, constrained, penalized and
biased requests join it too.

`chat(response_schema=)` appends the reference's schema instruction and,
when the schema compiles for this vocabulary (models/constrain.py),
grammar-constrains the decode; a schema `compile_schema` refuses stays
prompt-only, as in the reference.

`from_hf_dir` loads a local LLaMA-family checkpoint directory through
`transformers` (imported when called; the package is needed only there);
`lora_path=` merges a trained adapter (models/lora.py's npz) into the
weights before quantization.

Multi-LoRA serving: `register_lora` stacks each registered adapter into
banks in the decoder's dtype (models/lora.py::lora_banks, index 0 = the
base), and a chat selects one with ``adapter=name`` on the solo path and
through the batcher, where rows with different adapters share one decode
batch. LoRA chats never take the speculative path.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.decoder import (
    DecoderConfig,
    convert_hf_llama_state_dict,
    generate,
    generate_logprobs,
    init_kv_cache,
    make_decode_step,
    prefill,
    quantize_decoder_params,
    sample_logits,
    score_continuations,
)
from ..parallel import tp
from ..utils import DeviceLike, resolve_device


def _to_device(tree: Any, device: torch.device) -> Any:
    """The tree on ``device``; a sharded tree (parallel/tp.py) stays on
    its mesh, whose merge device must be ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tp.Sharded):
        if tree.device != device:
            raise ValueError(f"a tree sharded with merge device "
                             f"{tree.device} for a LocalLLM on {device}")
        return tree
    return tree.to(device)


class LocalLLM:
    """Chat adapter over decoder params + tokenizer.

    `tokenizer` needs `encode(text) -> List[int]` and
    `decode(ids) -> str` (models/wordpiece.py provides both). The params
    are moved to ``device`` (default: cuda); a tree sharded by
    `parallel/tp.py::shard_params` stays on its mesh and ``device`` is
    its merge device."""

    def __init__(self, params: Dict[str, Any], cfg: DecoderConfig,
                 tokenizer, *, eos_id: Optional[int] = None,
                 model_name: str = "local-decoder",
                 speculative: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        # greedy solo requests use prompt-lookup block verification
        # (models/speculative.py) when enabled
        self.speculative = bool(speculative)
        # WordPiece ends every encoded turn with [SEP]; that IS the
        # natural end-of-turn marker, so it doubles as eos
        if eos_id is None:
            eos_id = getattr(tokenizer, "sep_id", None)
            if eos_id is None:
                eos_id = getattr(tokenizer, "eos_token_id", 0) or 0
        self.eos_id = int(eos_id)
        self.pad_id = int(getattr(tokenizer, "pad_id", 0) or 0)
        self.model_name = model_name
        self._step = None  # lazy streaming step
        self._batcher = None  # optional continuous batcher (enable_batching)
        self._constraint_cache: Dict[str, Optional[Any]] = {}
        self._constraint_dev: Dict[str, Dict[str, Any]] = {}
        # multi-LoRA serving state (register_lora): the registered trees
        # with their alpha fallbacks, names -> bank index, stacked banks
        self._lora_trees: list = []
        self._lora_names: Dict[str, int] = {}
        self._lora_banks = None

    @classmethod
    def from_hf_dir(cls, model_dir: str, *, max_len: int = 1024,
                    dtype: str = "bfloat16", quantize: bool = False,
                    kv_quant: bool = False, lora_path: str = "",
                    lora_alpha: float = 16.0, device: DeviceLike = None,
                    **kw) -> "LocalLLM":
        """Load a local LLaMA-family HF checkpoint directory (never
        downloads). `quantize=True` serves weight-only int8;
        `kv_quant=True` stores the KV cache as int8 rows + per-row scales
        (models/decoder.py). `lora_path` merges trained LoRA factors
        (models/lora.py `save_adapters` npz, ``lora_alpha`` where it
        embeds no scale) into the weights at load, before quantization."""
        from transformers import (
            AutoConfig,
            AutoModelForCausalLM,
            AutoTokenizer,
        )

        hf_cfg = AutoConfig.from_pretrained(model_dir, local_files_only=True)
        rs = getattr(hf_cfg, "rope_scaling", None) or {}
        kind = rs.get("rope_type", rs.get("type", "none")) if rs else "none"
        if kind in ("default",):
            kind = "none"
        if kind not in ("none", "linear", "llama3"):
            raise ValueError(
                f"unsupported rope_scaling type {kind!r} (supported: "
                "linear, llama3)")
        cfg = DecoderConfig(
            vocab_size=hf_cfg.vocab_size, hidden=hf_cfg.hidden_size,
            num_layers=hf_cfg.num_hidden_layers,
            heads=hf_cfg.num_attention_heads,
            kv_heads=getattr(hf_cfg, "num_key_value_heads",
                             hf_cfg.num_attention_heads),
            mlp_dim=hf_cfg.intermediate_size,
            max_len=min(max_len, hf_cfg.max_position_embeddings),
            rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
            rope_kind=kind,
            rope_factor=float(rs.get("factor", 1.0)),
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_len=int(rs.get(
                "original_max_position_embeddings",
                hf_cfg.max_position_embeddings)),
            eps=getattr(hf_cfg, "rms_norm_eps", 1e-6), dtype=dtype,
            kv_quant=kv_quant)
        model = AutoModelForCausalLM.from_pretrained(
            model_dir, local_files_only=True)
        params = convert_hf_llama_state_dict(model.state_dict(), cfg,
                                             device=device)
        del model
        if lora_path:
            # merge the trained rank-r adapters into the dense weights
            # BEFORE quantization: no serving overhead
            from ..models.lora import load_adapters, lora_merge, lora_wrap_with

            dev = params["tok_emb"].device
            params = lora_merge(lora_wrap_with(
                params, load_adapters(lora_path, device=dev),
                alpha=lora_alpha))
        if quantize:
            params = quantize_decoder_params(params)
        tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
        return cls(params, cfg, tok, eos_id=tok.eos_token_id, device=device,
                   **kw)

    def enable_batching(self, *, slots: int = 8, prompt_pad: int = 256,
                        horizon: int = 512, chunk: int = 8,
                        temperature: float = 0.0, top_k: int = 64,
                        top_p: float = 1.0, seed: int = 0,
                        spec_k: int = 0, **batcher_kw):
        """Route `chat` and `stream` through a continuous batcher: N
        concurrent requests share ONE decode batch on the card
        (llm/scheduler.py). Sampling knobs are fixed per batcher; a call
        whose knobs differ falls back to the solo path. `spec_k`>0 adds
        prompt-lookup speculative blocks to every batch step. Returns the
        batcher."""
        from .scheduler import ContinuousBatcher

        self._batcher = ContinuousBatcher(
            self.params, self.cfg, slots=slots, prompt_pad=prompt_pad,
            horizon=horizon, chunk=chunk, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed, spec_k=spec_k,
            lora_banks=self._lora_banks, **batcher_kw)
        return self._batcher

    def register_prefix_text(self, text: str) -> int:
        """Prefix-cache a shared prompt header with the batcher: its K/V
        is computed once and every admission whose rendered prompt starts
        with it prefills only the suffix. The text must end on a token
        boundary of the render format (e.g. a full "system: ...\\n" line)
        so `encode(prefix+rest)` starts with `encode(prefix)`. Returns the
        prefix length in tokens."""
        if self._batcher is None:
            raise RuntimeError("enable_batching() first")
        ids = self.tokenizer.encode(text)
        if ids and ids[-1] == self.eos_id:
            ids = ids[:-1]
        self._batcher.register_prefix(ids)
        return len(ids)

    def register_lora(self, name: str, adapters_or_path, *,
                      alpha: float = 16.0) -> int:
        """Register a LoRA adapter for per-request serving. `name` is what
        chat requests select with ``adapter=name``; `adapters_or_path` is
        a `save_adapters` npz path or an adapter tree ({target: {"a", "b",
        optional "s"}}, tensors or numpy). All registered adapters share
        the frozen base: concurrent requests with different adapters
        decode in ONE batch. The banks are rebuilt in the decoder's dtype
        and handed to a live batcher. Returns the adapter's bank index.

        Unlike `from_hf_dir(lora_path=)` (one adapter merged into the
        weights), registered adapters are selectable per request."""
        from ..models.lora import load_adapters, lora_banks

        if isinstance(adapters_or_path, str):
            tree = load_adapters(adapters_or_path, device=self.device)
        else:
            tree = {t: {k: (v if isinstance(v, torch.Tensor)
                            else torch.from_numpy(np.array(v))).to(
                                self.device)
                        for k, v in ab.items()}
                    for t, ab in adapters_or_path.items()}
        self._lora_trees.append((tree, alpha))
        # rebuild the stacked banks (index i + 1 = the i-th registered)
        alphas = {a for _, a in self._lora_trees}
        if len(alphas) > 1:
            # lora_banks takes one alpha fallback; embedded "s" scales
            # win, so mixed alphas only matter for scale-less artifacts
            import logging

            logging.getLogger(__name__).warning(
                "register_lora: mixed alpha fallbacks %s; artifacts "
                "without embedded scales use the LAST alpha", alphas)
        self._lora_banks = lora_banks([t for t, _ in self._lora_trees],
                                      alpha=alpha,
                                      dtype=getattr(torch, self.cfg.dtype))
        idx = len(self._lora_trees)
        self._lora_names[name] = idx
        if self._batcher is not None:
            self._batcher._banks = self._lora_banks
        return idx

    def _lora_for(self, adapter) -> Optional[Dict[str, Any]]:
        """The solo path's ``lora`` argument (one row) for a named adapter
        (None = the base; None too while nothing is registered)."""
        if self._lora_banks is None:
            if adapter:
                raise ValueError(f"unknown adapter {adapter!r} "
                                 "(none registered)")
            return None
        if adapter:
            if adapter not in self._lora_names:
                raise ValueError(f"unknown adapter {adapter!r}")
            idx = self._lora_names[adapter]
        else:
            idx = 0
        return {"aid": torch.full((1,), idx, dtype=torch.int32,
                                  device=self.device),
                "banks": self._lora_banks}

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _bucketed(self, prompt_ids: Sequence[int]) -> np.ndarray:
        """(1, bucket) right-padded ids: the prompt padded to a power of
        two, capped at max_len - 1 (the reference's compile buckets; here
        they fix the cache geometry the same way)."""
        n = len(prompt_ids)
        bucket = 1
        while bucket < n:
            bucket <<= 1
        bucket = min(bucket, self.cfg.max_len - 1)
        ids = np.full((1, bucket), self.pad_id, np.int32)
        ids[0, :n] = prompt_ids
        return ids

    @staticmethod
    def _schema_key(schema) -> str:
        import json as _json

        return _json.dumps(schema, sort_keys=True)

    def _constraint_host_for(self, schema):
        """Compile (and cache) a response schema into a host-side
        grammar Constraint; None when the schema is outside the
        supported subset or the vocabulary can't realize it (the
        prompt-only fallback still applies)."""
        key = self._schema_key(schema)
        if key not in self._constraint_cache:
            from ..models.constrain import compile_schema

            try:
                self._constraint_cache[key] = compile_schema(
                    schema, self.tokenizer, self.cfg.vocab_size)
            except (ValueError, TypeError):
                self._constraint_cache[key] = None
        return self._constraint_cache[key]

    def _constraint_for(self, schema) -> Optional[Dict[str, Any]]:
        """Device view of the compiled constraint (solo path), on the
        model's device."""
        c = self._constraint_host_for(schema)
        if c is None:
            return None
        key = self._schema_key(schema)
        if key not in self._constraint_dev:
            self._constraint_dev[key] = c.as_device(self.device)
        return self._constraint_dev[key]

    def _constraint_cid_for(self, schema) -> Optional[int]:
        """Batcher constraint_id for the schema; None when the schema is
        unsupported OR the batcher's constraint bank is full of pinned
        slots (callers then take the solo constrained path). The batcher
        memoizes registration by constraint identity and LRU-evicts free
        slots, so calling this per request is O(1)."""
        c = self._constraint_host_for(schema)
        if c is None:
            return None
        try:
            return self._batcher.register_constraint(c)
        except ValueError:
            return None

    # ------------------------------------------------------------- prompt

    def render(self, messages: Sequence[Any]) -> List[int]:
        """Chat template -> prompt ids: plain role-tagged lines."""
        lines = []
        for m in messages:
            if hasattr(m, "role"):
                role, content = m.role, m.content
            else:
                role, content = m["role"], m.get("content", "")
            lines.append(f"{role}: {content}")
        lines.append("assistant:")
        ids = self.tokenizer.encode("\n".join(lines))
        # generation continues the sequence: drop a trailing [SEP]/eos so
        # the model doesn't see an already-ended turn
        if ids and ids[-1] == self.eos_id:
            ids = ids[:-1]
        return ids[-(self.cfg.max_len - 1):]

    def _decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) not in (self.pad_id, self.eos_id)]
        return self.tokenizer.decode(ids)

    @staticmethod
    def _apply_stop(text: str, stop) -> str:
        if not stop:
            return text
        for s in ([stop] if isinstance(stop, str) else stop):
            cut = text.find(s)
            if cut != -1:
                text = text[:cut]
        return text

    def _delta(self, produced: Sequence[int], emitted: str,
               stop) -> Tuple[str, str, bool]:
        """Incremental re-detokenization for `stream`: the text of
        `produced` past what was `emitted` (multi-piece words come out
        once whole), the new emitted text, and whether a stop string
        ended the stream."""
        text = self._decode(produced)
        if stop:
            clipped = self._apply_stop(text, stop)
            if clipped != text:
                return clipped[len(emitted):], emitted, True
        if text[: len(emitted)] == emitted:
            return text[len(emitted):], text, False
        return "", emitted, False

    # ---------------------------------------------------------- inference

    def generate_ids(self, prompt_ids: Sequence[int], *,
                     max_new: int = 128, temperature: float = 0.0,
                     top_k: int = 64, top_p: float = 1.0,
                     seed: int = 0, speculative: bool = False,
                     lora=None, presence: float = 0.0,
                     frequency: float = 0.0, constraint=None,
                     logit_bias=None) -> List[int]:
        """Blocking generation for one prompt, padded to a power-of-two
        bucket. `speculative=True` routes plain requests through
        prompt-lookup block verification (models/speculative.py): greedy
        output is the argmax of the same logits, and sampled output draws
        from the identical filtered distribution."""
        n = len(prompt_ids)
        max_new = max(1, min(max_new, self.cfg.max_len - n))
        ids = self._bucketed(prompt_ids)
        if (speculative and lora is None and constraint is None
                and logit_bias is None and not (presence or frequency)):
            from ..models.speculative import generate_lookup

            out, _ = generate_lookup(
                self.params, self.cfg, ids, np.asarray([n], np.int32),
                max_new, self.eos_id, self.pad_id, self._generator(seed), 4,
                float(temperature), int(top_k), float(top_p))
        else:
            out, _ = generate(
                self.params, self.cfg, ids, np.asarray([n], np.int32),
                max_new, self.eos_id, self.pad_id, self._generator(seed),
                float(temperature), int(top_k), float(top_p), lora,
                float(presence), float(frequency), constraint, logit_bias)
        out = out[0].cpu().numpy()
        return [int(t) for t in out if int(t) != self.pad_id
                and int(t) != self.eos_id]

    def generate_ids_logprobs(self, prompt_ids: Sequence[int], *,
                              max_new: int = 128, temperature: float = 0.0,
                              top_k: int = 64, top_p: float = 1.0,
                              seed: int = 0):
        """`generate_ids` that also returns each emitted token's raw
        model log-prob (decoder.generate_logprobs)."""
        n = len(prompt_ids)
        max_new = max(1, min(max_new, self.cfg.max_len - n))
        out, _, lps = generate_logprobs(
            self.params, self.cfg, self._bucketed(prompt_ids),
            np.asarray([n], np.int32), max_new, self.eos_id, self.pad_id,
            self._generator(seed), float(temperature), int(top_k),
            float(top_p))
        pairs = [(int(t), float(l))
                 for t, l in zip(out[0].cpu().numpy(), lps[0].cpu().numpy())
                 if int(t) not in (self.pad_id, self.eos_id)]
        return [t for t, _ in pairs], [l for _, l in pairs]

    def choose(self, prompt_ids: Sequence[int],
               choices: Sequence[Sequence[int]]) -> Tuple[int, List[float]]:
        """Exact log P(choice | prompt) for each candidate (one batched
        teacher-forced forward, decoder.score_continuations); returns
        (argmax index, per-choice log-probs)."""
        n = len(prompt_ids)
        lens = [n + len(c) for c in choices]
        bucket = 1
        while bucket < max(lens):
            bucket <<= 1
        bucket = min(bucket, self.cfg.max_len)
        ids = np.full((len(choices), bucket), self.pad_id, np.int32)
        for i, c in enumerate(choices):
            row = (list(prompt_ids) + list(c))[:bucket]
            ids[i, :len(row)] = row
        scores = score_continuations(
            self.params, self.cfg, ids, np.asarray([n] * len(choices)),
            np.asarray([min(l, bucket) for l in lens])).cpu().numpy()
        return int(np.argmax(scores)), [float(s) for s in scores]

    def choose_text(self, messages: Sequence[Any],
                    options: Sequence[str]) -> str:
        """Pick the most probable option string as the assistant's
        reply — guaranteed to BE one of the options."""
        prompt = self.render(messages)
        enc = []
        for o in options:
            ids = self.tokenizer.encode(o)
            if ids and ids[-1] == self.eos_id:
                ids = ids[:-1]
            enc.append(ids)
        i, _ = self.choose(prompt, enc)
        return options[i]

    def _logit_bias(self, params: Dict[str, Any]) -> Optional[np.ndarray]:
        """OpenAI logit_bias {"token_id": -100..100} -> (V,) f32 plane."""
        if not params.get("logit_bias"):
            return None
        vec = np.zeros((self.cfg.vocab_size,), np.float32)
        for tid, b in dict(params["logit_bias"]).items():
            tid = int(tid)
            if 0 <= tid < self.cfg.vocab_size:
                vec[tid] = float(b)
        return vec

    async def chat(self, messages: Sequence[Any], *,
                   tools=None, response_schema=None,
                   **params: Any):
        from .router import ChatMessage, LLMResponse

        adapter = params.get("adapter") or None
        msgs = list(messages)
        if response_schema is not None:
            import json as _json

            msgs.append(ChatMessage(
                "user", "Respond with ONLY valid JSON matching this "
                        f"schema: {_json.dumps(response_schema)}"))
        prompt = self.render(msgs)
        max_new = max(1, min(int(params.get("max_tokens") or 128),
                             self.cfg.max_len - len(prompt)))
        temperature = float(params.get("temperature") or 0.0)
        top_p = float(params.get("top_p") or 1.0)
        seed = int(params.get("seed") or 0)
        presence = float(params.get("presence_penalty") or 0.0)
        frequency = float(params.get("frequency_penalty") or 0.0)
        logit_bias = self._logit_bias(params)
        # a schema only "wants" the ext batcher when it actually compiles
        # to a constraint — rejected schemas (prompt-only fallback) would
        # otherwise forfeit the shared batch for nothing
        has_constraint = (response_schema is not None and
                          self._constraint_host_for(response_schema)
                          is not None)
        wants_ext = bool(presence or frequency or logit_bias is not None
                         or has_constraint)
        lp_out = None
        loop = asyncio.get_running_loop()
        if params.get("logprobs"):
            # logprobs ride the solo loop (the batcher does not thread
            # per-token scores through its chunks)
            out_ids, lps = await loop.run_in_executor(
                None, lambda: self.generate_ids_logprobs(
                    prompt, max_new=max_new, temperature=temperature,
                    top_p=top_p, seed=seed))
            lp_out = [{"token": self.tokenizer.decode([t]),
                       "logprob": l} for t, l in zip(out_ids, lps)]
        elif (not wants_ext
              and self._batch_eligible(prompt, max_new, params, temperature,
                                       top_p, adapter=adapter)):
            out_ids = await self._batcher.submit(
                prompt, max_new=max_new, eos_id=self.eos_id,
                adapter_id=(self._lora_names[adapter] if adapter else 0))
        elif (wants_ext and self._batcher is not None
              and self._batcher.sampling_ext
              and self._batch_eligible(prompt, max_new, params, temperature,
                                       top_p, adapter=adapter)
              and (not has_constraint
                   or (cid := self._constraint_cid_for(response_schema))
                   is not None)):
            # extended sampling THROUGH the shared batch (scheduler
            # sampling_ext). A compilable schema that cannot get a bank
            # slot (bank full of pinned constraints) drops to the solo
            # branch so the grammar guarantee holds.
            out_ids = await self._batcher.submit(
                prompt, max_new=max_new, eos_id=self.eos_id,
                adapter_id=(self._lora_names[adapter] if adapter else 0),
                constraint_id=(cid if has_constraint else 0),
                presence=presence, frequency=frequency,
                logit_bias=logit_bias)
        else:
            # grammar-constrain the decode whenever the schema compiles
            # — the instruction above tells the model WHAT to write,
            # the DFA guarantees the output parses either way
            constraint = (self._constraint_for(response_schema)
                          if response_schema is not None else None)
            out_ids = await loop.run_in_executor(
                None, lambda: self.generate_ids(
                    prompt, max_new=max_new, temperature=temperature,
                    top_p=top_p, seed=seed, speculative=self.speculative,
                    lora=self._lora_for(adapter),
                    presence=presence, frequency=frequency,
                    constraint=constraint, logit_bias=logit_bias))
        text = self._apply_stop(self._decode(out_ids), params.get("stop"))
        return LLMResponse(content=text,
                           usage={"prompt_tokens": len(prompt),
                                  "completion_tokens": len(out_ids),
                                  "total_tokens": len(prompt) + len(out_ids)},
                           logprobs=lp_out)

    def _batch_eligible(self, prompt, max_new, params, temperature,
                        top_p, adapter=None) -> bool:
        """A request rides the shared batch only when every sampling knob
        matches the batcher's AND the prompt fits prompt_pad (submit clips
        to the LAST prompt_pad tokens — a longer prompt would silently
        lose its head, i.e. the system prompt). Everything else falls back
        to the solo path. An unknown adapter name raises."""
        b = self._batcher
        if b is None:
            return False
        if adapter:
            if adapter not in self._lora_names:
                raise ValueError(f"unknown adapter {adapter!r}")
            if b._banks is None:
                return False  # batcher predates registration; solo path
        if temperature != b.temperature or top_p != b.top_p:
            return False
        if int(params.get("top_k") or b.top_k) != b.top_k:
            return False
        if temperature > 0 and params.get("seed") is not None:
            return False  # explicit seed: honor it via the solo path
        return len(prompt) <= b.T and len(prompt) + max_new <= b.S

    async def stream(self, messages: Sequence[Any],
                     **params: Any) -> AsyncIterator[str]:
        """Token-at-a-time decode: each yield is the newly produced text
        (incremental re-detokenization keeps multi-piece words right).
        With batching enabled, concurrent streams share one decode batch
        (time-to-next-token bounded by the chunk size)."""
        prompt = self.render(messages)
        max_new = max(1, min(int(params.get("max_tokens") or 128),
                             self.cfg.max_len - len(prompt)))
        temperature = float(params.get("temperature") or 0.0)
        top_p = float(params.get("top_p") or 1.0)
        seed = int(params.get("seed") or 0)
        stop = params.get("stop")
        loop = asyncio.get_running_loop()
        presence = float(params.get("presence_penalty") or 0.0)
        frequency = float(params.get("frequency_penalty") or 0.0)
        logit_bias = self._logit_bias(params)
        wants_ext = bool(presence or frequency or logit_bias is not None)
        if (self._batch_eligible(prompt, max_new, params, temperature, top_p)
                and (not wants_ext or self._batcher.sampling_ext)):
            produced: List[int] = []
            emitted = ""
            async for tok in self._batcher.submit_stream(
                    prompt, max_new=max_new, eos_id=self.eos_id,
                    presence=presence, frequency=frequency,
                    logit_bias=logit_bias):
                produced.append(tok)
                delta, emitted, stopped = self._delta(produced, emitted,
                                                      stop)
                if delta:
                    yield delta
                if stopped:
                    return
            return

        if wants_ext:
            # the per-token step below has no penalty state, so it would
            # apply a DIFFERENT sampling law than chat() for these knobs:
            # run the penalty-aware generate and stream its output by
            # incremental re-detokenization
            out_ids = await loop.run_in_executor(
                None, lambda: self.generate_ids(
                    prompt, max_new=max_new, temperature=temperature,
                    top_p=top_p, seed=seed, presence=presence,
                    frequency=frequency, logit_bias=logit_bias))
            emitted = ""
            for k in range(1, len(out_ids) + 1):
                delta, emitted, stopped = self._delta(out_ids[:k], emitted,
                                                      stop)
                if delta:
                    yield delta
                if stopped:
                    return
            return

        if self._step is None:
            self._step = make_decode_step(self.params, self.cfg)
        gen = self._generator(seed)

        def _prefill():
            n = len(prompt)
            ck, cv = init_kv_cache(self.cfg, 1, device=self.device)
            logits, ck, cv = prefill(
                self.params, self.cfg,
                torch.from_numpy(self._bucketed(prompt)).to(self.device),
                torch.tensor([n], dtype=torch.int32, device=self.device),
                ck, cv)
            tok = sample_logits(logits, gen, temperature=temperature,
                                top_k=64, top_p=top_p)
            return int(tok[0]), ck, cv

        tok, ck, cv = await loop.run_in_executor(None, _prefill)
        produced: List[int] = []
        emitted = ""
        pos = len(prompt)
        for step in range(max_new):
            if tok == self.eos_id:
                break
            produced.append(tok)
            delta, emitted, stopped = self._delta(produced, emitted, stop)
            if delta:
                yield delta
            if stopped:
                return
            if step == max_new - 1:
                break
            tok_a, ck, cv = await loop.run_in_executor(
                None, lambda t=tok, p=pos: self._step(
                    np.asarray([t], np.int32), np.asarray([p], np.int32),
                    ck, cv, gen, temperature, 64, top_p))
            tok = int(tok_a[0])
            pos += 1
