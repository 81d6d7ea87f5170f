"""On-device text generation provider.

Port of `rag_application_tpu/llm/local.py`: `LocalLLM` adapts the
port's decoder (models/decoder.py) to the router's chat interface, so
anything that speaks `LLMRouter` can generate on the local card
(`Provider.LOCAL`). Two solo paths, as in the reference:

  * `chat`: `generate` — prefill plus the decode loop for one prompt;
  * `stream`: a single-token step per yield (time to first token =
    prefill + one step), or, for penalized/biased requests, the
    penalty-aware `generate` streamed by incremental re-detokenization.

Both run the blocking device work in an executor so the serving event
loop stays free.

`chat(response_schema=)` appends the reference's schema instruction and,
when the schema compiles for this vocabulary (models/constrain.py),
grammar-constrains the decode; a schema `compile_schema` refuses stays
prompt-only, as in the reference.

Not ported yet, and raising until their modules are: continuous batching
(`enable_batching`, llm/scheduler.py), prompt-lookup speculation
(`speculative=True`, models/speculative.py), multi-LoRA serving
(`register_lora`, models/lora.py) and checkpoint loading
(`from_hf_dir`, which needs `transformers` and a model directory).
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.decoder import (
    DecoderConfig,
    generate,
    generate_logprobs,
    init_kv_cache,
    make_decode_step,
    prefill,
    sample_logits,
    score_continuations,
)
from ..utils import DeviceLike, resolve_device


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class LocalLLM:
    """Chat adapter over decoder params + tokenizer.

    `tokenizer` needs `encode(text) -> List[int]` and
    `decode(ids) -> str` (models/wordpiece.py provides both). The params
    are moved to ``device`` (default: cuda)."""

    def __init__(self, params: Dict[str, Any], cfg: DecoderConfig,
                 tokenizer, *, eos_id: Optional[int] = None,
                 model_name: str = "local-decoder",
                 speculative: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer
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
        self._constraint_cache: Dict[str, Optional[Any]] = {}
        self._constraint_dev: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def from_hf_dir(cls, model_dir: str, **kw) -> "LocalLLM":
        raise NotImplementedError(
            "LocalLLM.from_hf_dir is not ported yet: build the params with "
            "models.decoder.convert_hf_llama_state_dict")

    def enable_batching(self, **kw):
        raise NotImplementedError(
            "continuous batching is not ported yet (llm/scheduler.py)")

    def register_lora(self, name: str, adapters_or_path, *,
                      alpha: float = 16.0) -> int:
        raise NotImplementedError(
            "multi-LoRA serving is not ported yet (models/lora.py)")

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

    # ---------------------------------------------------------- inference

    def generate_ids(self, prompt_ids: Sequence[int], *,
                     max_new: int = 128, temperature: float = 0.0,
                     top_k: int = 64, top_p: float = 1.0,
                     seed: int = 0, speculative: bool = False,
                     lora=None, presence: float = 0.0,
                     frequency: float = 0.0, constraint=None,
                     logit_bias=None) -> List[int]:
        """Blocking generation for one prompt, padded to a power-of-two
        bucket. `speculative=True` (prompt-lookup verification) raises
        until models/speculative.py is ported."""
        n = len(prompt_ids)
        max_new = max(1, min(max_new, self.cfg.max_len - n))
        ids = self._bucketed(prompt_ids)
        if (speculative and lora is None and constraint is None
                and logit_bias is None and not (presence or frequency)):
            raise NotImplementedError(
                "speculative decoding is not ported yet "
                "(models/speculative.py)")
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

        if params.get("adapter"):
            raise ValueError(f"unknown adapter {params['adapter']!r} "
                             "(none registered)")
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
        lp_out = None
        loop = asyncio.get_running_loop()
        if params.get("logprobs"):
            out_ids, lps = await loop.run_in_executor(
                None, lambda: self.generate_ids_logprobs(
                    prompt, max_new=max_new, temperature=temperature,
                    top_p=top_p, seed=seed))
            lp_out = [{"token": self.tokenizer.decode([t]),
                       "logprob": l} for t, l in zip(out_ids, lps)]
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
                    presence=presence, frequency=frequency,
                    constraint=constraint, logit_bias=logit_bias))
        text = self._apply_stop(self._decode(out_ids), params.get("stop"))
        return LLMResponse(content=text,
                           usage={"prompt_tokens": len(prompt),
                                  "completion_tokens": len(out_ids),
                                  "total_tokens": len(prompt) + len(out_ids)},
                           logprobs=lp_out)

    async def stream(self, messages: Sequence[Any],
                     **params: Any) -> AsyncIterator[str]:
        """Token-at-a-time decode: each yield is the newly produced text
        (incremental re-detokenization keeps multi-piece words right)."""
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

        if presence or frequency or logit_bias is not None:
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
                text = self._decode(out_ids[:k])
                if stop:
                    clipped = self._apply_stop(text, stop)
                    if clipped != text:
                        delta = clipped[len(emitted):]
                        if delta:
                            yield delta
                        return
                if text[: len(emitted)] == emitted:
                    delta = text[len(emitted):]
                    if delta:
                        yield delta
                        emitted = text
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
            text = self._decode(produced)
            if stop:
                clipped = self._apply_stop(text, stop)
                if clipped != text:
                    delta = clipped[len(emitted):]
                    if delta:
                        yield delta
                    return
            if text[: len(emitted)] == emitted:
                delta = text[len(emitted):]
                if delta:
                    yield delta
                    emitted = text
            if step == max_new - 1:
                break
            tok_a, ck, cv = await loop.run_in_executor(
                None, lambda t=tok, p=pos: self._step(
                    np.asarray([t], np.int32), np.asarray([p], np.int32),
                    ck, cv, gen, temperature, 64, top_p))
            tok = int(tok_a[0])
            pos += 1
