"""Ollama GGUF auto-provisioning client.

Copy of `rag_application_tpu/llm/provision.py`.

Parity: `OllamaClient.ensure_model_available` (app/core/models/ollama/
ollama.py:194-298) — when a requested model is not registered in Ollama,
the reference drives an external GGUF converter service (HF repo ->
quantized GGUF), polls the conversion task, downloads the artifact,
uploads it to Ollama's blob store by sha256 digest, and registers the
model. The converter and Ollama are external HTTP services in both
systems; transport here is httpx with an injectable client factory so
the whole workflow is testable offline.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Optional


def _file_chunks(f, size: int = 4 << 20):
    """Async chunk iterator over an open file (httpx streams it as the
    request body — memory stays at chunk size, not artifact size)."""
    async def gen():
        while True:
            b = f.read(size)
            if not b:
                return
            yield b

    return gen()


@dataclass
class GGUFProvisionConfig:
    ollama_url: str = "http://localhost:11434"
    converter_url: str = "http://localhost:8001"
    hf_repo: str = ""
    quantization: str = "Q8_0"  # reference default (app/config.py)
    hf_token: Optional[str] = None
    poll_interval_s: float = 5.0
    max_polls: int = 720  # 1h at 5s, like the reference's upload timeout


class ProvisionError(RuntimeError):
    pass


class GGUFProvisioner:
    """Drives converter + Ollama registration for one model name."""

    def __init__(self, model_name: str, cfg: GGUFProvisionConfig,
                 *, client_factory: Optional[Callable] = None):
        self.model_name = model_name
        self.cfg = cfg
        if client_factory is None:
            import httpx

            client_factory = lambda: httpx.AsyncClient(timeout=3600)  # noqa: E731
        self._client_factory = client_factory

    async def _registered_models(self, client) -> set:
        """Registered names, both fully-tagged and tag-stripped, so
        'llama3:8b' matches whether the caller asks with or without the
        tag (stripping only would re-provision 'llama3:8b' forever)."""
        r = await client.get(f"{self.cfg.ollama_url}/api/tags")
        r.raise_for_status()
        names = set()
        for m in r.json().get("models", []):
            full = m.get("name", "")
            if full:
                names.add(full)
                names.add(full.rsplit(":", 1)[0])
        return names

    async def ensure_model_available(self) -> str:
        """Returns the model name once registered (converting if needed).

        Mirrors the reference's flow step for step: registry check ->
        /convert -> poll /status/{task} -> download artifact -> upload
        blob sha256:... -> /api/create (ollama.py:194-298). Raises
        ProvisionError instead of returning None on failure.
        """
        cfg = self.cfg
        async with self._client_factory() as client:
            if self.model_name in await self._registered_models(client):
                return self.model_name
            if not cfg.hf_repo:
                raise ProvisionError(
                    f"model {self.model_name!r} not registered and no "
                    "hf_repo configured for conversion")

            # 1. start conversion
            r = await client.post(f"{cfg.converter_url}/convert", json={
                "repo_id": cfg.hf_repo,
                "quantization": cfg.quantization,
                "token": cfg.hf_token,
            })
            if r.status_code != 200:
                raise ProvisionError(f"conversion start failed: {r.text}")
            task_id = r.json().get("task_id")
            if not task_id:
                raise ProvisionError("converter returned no task_id")

            # 2. poll until the status flips from Processing to a URL
            #    (the reference overloads `status` with the artifact URL)
            artifact_url = None
            for _ in range(cfg.max_polls):
                r = await client.get(f"{cfg.converter_url}/status/{task_id}")
                if r.status_code != 200:
                    raise ProvisionError("conversion status fetch failed")
                status = r.json().get("status")
                if status == "Failed":
                    raise ProvisionError("model conversion failed")
                if isinstance(status, str) and status.startswith("http"):
                    # done: the converter overloads `status` with the
                    # artifact URL
                    artifact_url = status
                    break
                # anything else (Processing/Queued/Pending/...) is an
                # in-flight state — keep polling; guessing that an
                # unknown word is a URL turned 'Queued' into a broken
                # GET and burned none of the polling budget
                await asyncio.sleep(cfg.poll_interval_s)
            if artifact_url is None:
                raise ProvisionError("conversion timed out")

            # 3. stream the GGUF artifact to a temp file with an
            #    incremental sha256 — a Q8_0 8B artifact is ~8.5 GB,
            #    buffering it (twice, once for the re-upload) OOMs
            import tempfile

            h = hashlib.sha256()
            with tempfile.NamedTemporaryFile(suffix=".gguf") as tmp:
                async with client.stream("GET", artifact_url) as r:
                    if r.status_code != 200:
                        raise ProvisionError("artifact download failed")
                    async for chunk in r.aiter_bytes():
                        h.update(chunk)
                        tmp.write(chunk)
                tmp.flush()
                digest = "sha256:" + h.hexdigest()

                # 4. upload to Ollama's blob store by digest (file-backed
                #    body: httpx streams it, memory stays at buffer size)
                tmp.seek(0)
                r = await client.post(
                    f"{cfg.ollama_url}/api/blobs/{digest}",
                    content=tmp.read() if os.path.getsize(tmp.name)
                    < (64 << 20) else _file_chunks(tmp))
                if r.status_code not in (200, 201):
                    raise ProvisionError("blob upload failed")

            # 5. register the model against the uploaded blob
            r = await client.post(f"{cfg.ollama_url}/api/create", json={
                "model": self.model_name,
                "files": {f"{task_id}.gguf": digest},
            })
            if r.status_code != 200:
                raise ProvisionError("model registration failed")
            return self.model_name
