"""rag_application_tpu_torch — the PyTorch/CUDA port of rag_application_tpu.

The JAX package `rag_application_tpu` is the reference; this package
keeps its module paths and public names so each piece has an obvious
counterpart, and never imports JAX or anything of the JAX package.

Layering (bottom-up), as far as the port reaches so far:
  csrc/      hand-written CUDA kernels for Hopper (sm_90a): the fused
             int8/bf16 similarity scan, the BM25 match, the int8-KV
             flash-decode attention and the insert-time prep pass
  kernels/   nvcc build of csrc/ into one shared library, loaded via ctypes
  ops/       kernel wrappers (each with its plain PyTorch version) and the
             plain tensor ops around them: quantization and the insert
             prep, top-k, RRF, BM25, decode attention
  index/     device-resident dense index, BM25 index, host payload store
  search/    the hybrid query funnel (`search.fused.FusedSearcher`, with
             the tokens wire), `adaptive_funnel`, the maxsim reranker
  models/    the text encoder + `Embedder`, the LLaMA-family decoder, the
             hash and WordPiece tokenizers
  store/     `Collection` / `VectorStore`: ingest and hybrid search
  llm/       the provider router and `LocalLLM` (on-device generation)
  state.py   builds the port's indexes, encoder and decoder weights from
             the JAX package's arrays

Entry points run on CUDA unless the caller passes a CPU device; on a CPU
tensor every kernel wrapper takes its plain version.
"""

__version__ = "0.1.0"
