"""Service entrypoint: `python -m rag_application_tpu_torch.serve`.

Port of `rag_application_tpu/serve.py`. The app and its user spaces run
on ``cuda`` (which raises without a card); ``RAGTPU_PLATFORM=cpu`` asks
for the CPU. `restore_spaces`/`checkpoint_spaces` load and save on the
app's device. `RAGTPU_LLM_PROVIDER=local` loads `LocalLLM.from_hf_dir`
(which needs `transformers`); its `RAGTPU_LOCAL_BATCH_*` settings turn on
continuous batching and `RAGTPU_LOCAL_SPECULATIVE=1` prompt-lookup
speculation. `RAGTPU_LOCAL_LORA` (with `RAGTPU_LOCAL_LORA_ALPHA`) merges
one adapter npz into the weights at load, and
`RAGTPU_LOCAL_LORA_ADAPTERS` (``name=path,...``) registers adapters that
chat requests select with ``{"adapter": name}`` (models/lora.py).

Boots the full stack the way the reference's docker-compose assembles its
services (app/main.py lifespan: connect stores, spawn background tasks) —
here one process: config from env (RAGTPU_* overrides), encoder + LLM
router, HTTP API with all endpoints, MCP mounted at /mcp, periodic KG
deduplication per user space.
"""

from __future__ import annotations

import asyncio
import logging
import os


def space_fingerprint(sp) -> tuple:
    """Change signal for skip-if-unchanged snapshots. Includes the
    MONOTONIC dense.size and sparse doc count so delete+reinsert cycles
    that leave the live chunk count unchanged still trigger a save."""
    return (sp.collection.dense.size, len(sp.collection.sparse),
            sp.collection.chunk_count(),
            tuple(sorted(sp.kg.stats().items())))


def restore_spaces(state, ckpt_dir: str) -> list:
    """Load every user space found under `ckpt_dir` (one subdir per user,
    the layout `checkpoint_spaces` writes). Returns restored user ids.

    The user id is recovered from the checkpoint manifest (collection
    name "user_<id>"), NOT from the directory name — directories are
    filesystem-safe digests of the id."""
    from .api.app import UserSpace
    from .index.checkpoint import load_collection
    from .kg.checkpoint import load_kg

    restored = []
    if not os.path.isdir(ckpt_dir):
        return restored
    # accounts + custom agents + the token secret (so outstanding
    # tokens survive a restart) live beside the space checkpoints
    upath = os.path.join(ckpt_dir, "users.json")
    if os.path.isfile(upath):
        try:
            import json

            with open(upath) as f:
                payload = json.load(f)
            if getattr(state, "user_registry", None) is not None:
                state.user_registry.from_state(payload.get("users", {}))
            if getattr(state, "agent_registry", None) is not None:
                state.agent_registry.from_state(payload.get("agents", {}))
            logging.info("restored %d user accounts",
                         len(payload.get("users", {}).get("users", [])))
        except Exception:  # noqa: BLE001
            logging.exception("user-registry restore failed")
    for entry in sorted(os.listdir(ckpt_dir)):
        path = os.path.join(ckpt_dir, entry)
        if not os.path.isdir(os.path.join(path, "collection")):
            continue
        try:
            col = load_collection(os.path.join(path, "collection"),
                                  state.config, device=state.device)
            kg = load_kg(os.path.join(path, "kg"), state.config.kg,
                         device=state.device)
            if not col.name.startswith("user_"):
                # The directory name is a digest, not the user id —
                # registering under it would make the data unreachable
                # by any request. Surface the problem instead.
                logging.warning(
                    "skipping checkpoint %r: manifest collection name %r "
                    "does not encode a user id", entry, col.name)
                continue
            user_id = col.name[len("user_"):]
            pipe = state.make_pipeline(user_id, col, kg)
            state.users[user_id] = UserSpace(col, kg, pipe)
            restored.append(user_id)
            logging.info("restored space %r: %d chunks",
                         user_id, col.chunk_count())
        except Exception:  # noqa: BLE001
            logging.exception("restore of %r failed", entry)
    return restored


def checkpoint_spaces(state, ckpt_dir: str, saved_fp: dict) -> list:
    """Snapshot every user space whose fingerprint moved since the last
    save (atomic-by-rename per space). Returns saved user ids.

    user_id comes from request bodies — it must never influence the
    path (save_collection rmtree's siblings of its target), so the
    per-user directory is the filesystem-safe digest name."""
    from .index.checkpoint import save_collection
    from .kg.checkpoint import save_kg

    saved = []
    for user_id, sp in list(state.users.items()):
        try:
            fp = space_fingerprint(sp)
            if saved_fp.get(user_id) == fp:
                continue
            path = os.path.join(ckpt_dir, state._fs_safe(user_id))
            os.makedirs(path, exist_ok=True)
            save_collection(sp.collection, os.path.join(path, "collection"))
            save_kg(sp.kg, os.path.join(path, "kg"))
            saved_fp[user_id] = fp
            saved.append(user_id)
            logging.info("checkpointed space %r", user_id)
        except Exception:  # noqa: BLE001
            logging.exception("checkpoint of %r failed", user_id)
    # user/agent registries (skip-if-unchanged; atomic-by-rename)
    try:
        import json

        reg = getattr(state, "user_registry", None)
        areg = getattr(state, "agent_registry", None)
        if reg is not None:
            payload = {"users": reg.to_state(),
                       "agents": areg.to_state() if areg else {}}
            blob = json.dumps(payload, sort_keys=True)
            if saved_fp.get("__users__") != blob:
                os.makedirs(ckpt_dir, exist_ok=True)
                tmp = os.path.join(ckpt_dir, ".users.json.tmp")
                with open(tmp, "w") as f:
                    f.write(blob)
                os.replace(tmp, os.path.join(ckpt_dir, "users.json"))
                saved_fp["__users__"] = blob
    except Exception:  # noqa: BLE001
        logging.exception("user-registry checkpoint failed")
    return saved


def main() -> None:
    logging.basicConfig(level=os.environ.get("LOG_LEVEL", "INFO"))
    # RAGTPU_PLATFORM=cpu serves off the card deliberately; unset means
    # cuda, which raises when no card is found
    device = os.environ.get("RAGTPU_PLATFORM") or None
    from .api.app import build_app
    from .api.http import HTTPServer
    from .config import Config
    from .llm.router import LLMRouter, Provider

    cfg = Config.from_env()
    provider = Provider(os.environ.get("RAGTPU_LLM_PROVIDER", "stub"))
    local = None
    if provider == Provider.LOCAL:
        # on-chip generation: RAGTPU_LOCAL_MODEL_DIR points at a local
        # LLaMA-family HF checkpoint directory (llm/local.py; parity:
        # the reference's HF local client, huggingface.py:17-22)
        from .llm.local import LocalLLM

        model_dir = os.environ.get("RAGTPU_LOCAL_MODEL_DIR")
        if not model_dir:
            raise SystemExit(
                "RAGTPU_LLM_PROVIDER=local needs RAGTPU_LOCAL_MODEL_DIR "
                "(a local LLaMA-family HF checkpoint directory)")
        local = LocalLLM.from_hf_dir(
            model_dir,
            quantize=os.environ.get("RAGTPU_LOCAL_QUANT", "0") == "1",
            kv_quant=os.environ.get("RAGTPU_LOCAL_KV_QUANT", "0") == "1",
            lora_path=os.environ.get("RAGTPU_LOCAL_LORA", ""),
            lora_alpha=float(os.environ.get("RAGTPU_LOCAL_LORA_ALPHA",
                                            "16")),
            speculative=os.environ.get(
                "RAGTPU_LOCAL_SPECULATIVE", "0") == "1")
        # multi-LoRA serving: "name=path.npz,name2=path2.npz" registers
        # per-request-selectable adapters over the frozen base (requests
        # pick one with the OpenAI param {"adapter": "name"}); unlike
        # RAGTPU_LOCAL_LORA (merge-at-load), all of them serve at once.
        adapters = os.environ.get("RAGTPU_LOCAL_LORA_ADAPTERS", "")
        for spec in filter(None, (s.strip() for s in adapters.split(","))):
            name, _, path = spec.partition("=")
            if not path:
                raise SystemExit(
                    f"RAGTPU_LOCAL_LORA_ADAPTERS entry {spec!r} must be "
                    "name=path.npz")
            local.register_lora(name.strip(), path.strip())
            logging.info("registered LoRA adapter %r", name.strip())
        # RAGTPU_LOCAL_BATCH_SLOTS>0 serves concurrent chats from ONE
        # continuous decode batch (llm/scheduler.py) instead of
        # serializing fused generate calls on the chip
        slots = int(os.environ.get("RAGTPU_LOCAL_BATCH_SLOTS", "0"))
        if slots > 0:
            local.enable_batching(
                slots=slots,
                prompt_pad=int(os.environ.get(
                    "RAGTPU_LOCAL_BATCH_PROMPT", "256")),
                horizon=int(os.environ.get(
                    "RAGTPU_LOCAL_BATCH_HORIZON", "512")),
                chunk=int(os.environ.get("RAGTPU_LOCAL_BATCH_CHUNK", "8")),
                spec_k=int(os.environ.get("RAGTPU_LOCAL_BATCH_SPEC_K", "0")),
                spec_min_tps=float(os.environ.get(
                    "RAGTPU_LOCAL_BATCH_SPEC_MIN_TPS", "0")),
                spec_cooldown=int(os.environ.get(
                    "RAGTPU_LOCAL_BATCH_SPEC_COOLDOWN", "16")),
                # =1: grammar-constrained / penalized / logit_bias
                # requests share the batch too (llm/scheduler.py
                # sampling_ext) instead of falling back to the solo
                # fused path; composes with SPEC_K>0 (masked verify)
                sampling_ext=os.environ.get(
                    "RAGTPU_LOCAL_BATCH_EXT", "0") == "1",
                # cap on concurrently-registered grammar banks (LRU
                # eviction beyond it; full-of-pinned-slots requests
                # fall back to the solo constrained path)
                max_constraints=int(os.environ.get(
                    "RAGTPU_LOCAL_BATCH_MAX_CONSTRAINTS", "8")))
            # prefix-cache a shared system header (text, token-boundary
            # aligned with the render format) so admissions prefill only
            # their suffix
            prefix_text = os.environ.get("RAGTPU_LOCAL_BATCH_PREFIX")
            if prefix_text:
                n = local.register_prefix_text(prefix_text)
                logging.info("prefix-cached %d tokens for the batcher", n)
    llm = LLMRouter(
        provider,
        model=os.environ.get("RAGTPU_LLM_MODEL", "stub-model"),
        base_url=os.environ.get("RAGTPU_LLM_BASE_URL"),
        api_key=os.environ.get("RAGTPU_LLM_API_KEY"),
        local=local,
    )

    # LLM-in-the-loop ingest stages (parity: per-page KG extraction +
    # VLM alt-text, _unstructured_processor.py:44-66). "auto" = on when
    # a real provider is configured; the stub would only produce noise.
    def _stage_on(env: str) -> bool:
        mode = os.environ.get(env, "auto")
        return mode == "1" or (mode == "auto" and provider != Provider.STUB)

    kg_extractor = None
    if _stage_on("RAGTPU_KG_EXTRACT"):
        from .kg.extract import EntityRelationExtractor

        kg_extractor = EntityRelationExtractor(llm).extract
    page_describer = None
    if _stage_on("RAGTPU_VLM"):
        import base64

        from .llm.vlm import VLMProcessor

        vlm = VLMProcessor(llm)

        async def page_describer(image: bytes) -> str:  # noqa: F811
            return await vlm.describe(base64.b64encode(image).decode())

    router, state = build_app(cfg, llm=llm,
                              api_key=os.environ.get("RAGTPU_API_KEY"),
                              kg_extractor=kg_extractor,
                              page_describer=page_describer,
                              device=device)

    host = os.environ.get("RAGTPU_HOST", "0.0.0.0")
    port = int(os.environ.get("RAGTPU_PORT", "8000"))
    server = HTTPServer(router, host=host, port=port)

    # continuous durability (SURVEY §5.4): the reference leans on docker
    # volumes under Qdrant/Neo4j; here the framework owns it — restore
    # user spaces from RAGTPU_CHECKPOINT_DIR at boot, then snapshot any
    # space that changed every RAGTPU_CHECKPOINT_INTERVAL seconds
    # (atomic-by-rename, see index/checkpoint.py).
    ckpt_dir = os.environ.get("RAGTPU_CHECKPOINT_DIR")
    saved_fp: dict = {}
    if ckpt_dir:
        restore_spaces(state, ckpt_dir)
        saved_fp = {u: space_fingerprint(sp)
                    for u, sp in state.users.items()}

    async def run() -> None:
        # background KG dedup across user spaces (parity: the reference's
        # per-user deduplication interval, deduplicator.py:161-169)
        from .kg.dedup import deduplicate

        async def dedup_loop():
            interval = float(os.environ.get("RAGTPU_DEDUP_INTERVAL", "300"))
            loop = asyncio.get_running_loop()
            while True:
                await asyncio.sleep(interval)
                for space in list(state.users.values()):
                    try:
                        # kNN + merge work — off the event loop, like
                        # the checkpoint loop, so requests stay live
                        await loop.run_in_executor(
                            None, deduplicate, space.kg)
                    except Exception:  # noqa: BLE001
                        logging.exception("dedup pass failed")

        async def checkpoint_loop():
            interval = float(
                os.environ.get("RAGTPU_CHECKPOINT_INTERVAL", "300"))
            loop = asyncio.get_running_loop()
            while True:
                await asyncio.sleep(interval)
                # snapshots pull multi-GiB tables to host — keep them off
                # the event loop so requests stay responsive
                await loop.run_in_executor(
                    None, checkpoint_spaces, state, ckpt_dir, saved_fp)

        # hold strong references: the event loop keeps only weak refs to
        # tasks, and an unreferenced background loop can be GC'd mid-
        # sleep — dedup/checkpointing would silently stop
        background = [asyncio.ensure_future(dedup_loop())]
        if ckpt_dir:
            background.append(asyncio.ensure_future(checkpoint_loop()))
        try:
            await server.serve_forever()
        finally:
            for t in background:
                t.cancel()

    asyncio.run(run())


if __name__ == "__main__":
    main()
