"""Fused similarity scan + top-k: no score matrix in device memory.

Port of `rag_application_tpu/ops/fused_topk.py`. For every corpus block
and query, the scan reduces the (Q, block) score tile to 128 lane bins —
bin `lane` holds the strided rows {lane, lane+128, ...} of the block (or
of each strip, with ``strip_outputs``), keeps its max and row id, and
breaks ties toward the smaller row — and writes only that candidate
sheet. The caller top-ks the sheet and exact-rescores the winners.

`scan_sheet` is the kernel wrapper: on a CUDA tensor it launches one of
the three CUDA kernels that port the Pallas `_scan_kernel` (`scan_route`
says which), on a CPU tensor it runs `scan_sheet_plain`, the same
arithmetic in plain PyTorch. Both produce the same sheet — bins, winners,
row ids, tie-breaks and sentinels — for all three reduce paths:

  * packed (int8, no scale): one int32 key `score*rows + (rows-1-row)`,
    exact while `_packed_fits`;
  * packed_scaled (int8 with per-row f32 scale): the f32 score mapped to
    a total-order int32 key with the low row bits cleared (values come
    back truncated by those bits, as in the reference);
  * general (int8 without the packed bound, or bf16/f32): max, then the
    smallest row among the hits.

Which kernel a scan takes, by corpus and query type:

  * int8 corpus + int8 queries, every reduce path:
    `csrc/fused_scan_int8.cu` (tensor cores, `mma.sync` s8), bit-equal to
    the plain version;
  * bf16 corpus + bf16 queries (what `fused_core` passes on the cascade's
    prefix scan), rows and pointers on 4-byte boundaries:
    `csrc/fused_scan_bf16.cu` (tensor cores, `mma.sync` bf16): the plain
    version's exact products, summed in f32 in another order;
  * an f32 corpus, f32 queries on a bf16 corpus, or a bf16 scan with an
    odd depth, an odd row stride or a pointer off a 4-byte boundary
    (`cp.async` cannot copy those; its queries are upcast to f32):
    `csrc/fused_scan.cu` (CUDA cores, `fmaf`).

Bitcasts are `.view()` reinterprets, never `.to()` casts, and the packed
decode is a floor division, as `//` is in JAX.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from ..kernels import launch, ptr
from ..utils import cdiv, round_up
from .topk import dot_scores, stable_topk

NEG = -3.0e38
LANES = 128  # bins per block

# cap on the live candidate-sheet bytes (f32 vals + s32 ids) before
# fused_scan_topk chunks the query axis (same budget as the reference)
_SHEET_BYTES_BUDGET = 1 << 30

_INT_MIN = -(2 ** 31)
# reduce path (fused_scan_topk.last_path) -> the kernel's reduce mode
_MODES = {"packed": 0, "packed_scaled": 1, "int8_general": 2, "f32": 2}
# route (the kernel's source in csrc/) -> fused_scan_launch's dtype code
# for it, by corpus dtype
ROUTES = ("fused_scan_int8", "fused_scan_bf16", "fused_scan")
_DTYPE_CODES = {("fused_scan_int8", torch.int8): 0,
                ("fused_scan", torch.bfloat16): 1,
                ("fused_scan", torch.float32): 2,
                ("fused_scan_bf16", torch.bfloat16): 3}
# launches of each route by `scan_sheet`; their sum is `scan_sheet.launches`
# unless a caller reset one without the other
route_launches = dict.fromkeys(ROUTES, 0)


def scan_route(corpus_dtype: torch.dtype, query_dtype: torch.dtype, d: int,
               row_stride: int, corpus_ptr: int, query_ptr: int) -> str:
    """The CUDA kernel (one of `ROUTES`) that `scan_sheet` launches for a
    corpus of ``corpus_dtype`` with ``d`` columns, a row stride of
    ``row_stride`` elements and its first element at address
    ``corpus_ptr``, and contiguous queries of ``query_dtype`` at
    ``query_ptr``. A function of these alone, so it can be asked without
    a card."""
    if corpus_dtype == torch.int8:
        return "fused_scan_int8"
    if (corpus_dtype == torch.bfloat16 and query_dtype == torch.bfloat16
            and d % 2 == 0 and row_stride % 2 == 0
            and corpus_ptr % 4 == 0 and query_ptr % 4 == 0):
        return "fused_scan_bf16"
    return "fused_scan"


def _packed_fits(d: int, block_rows: int) -> bool:
    """Packed int32 bin-max is exact iff |score|*rows + rows fits int32
    (|score| <= d*127*127 for int8 x int8 dots)."""
    rows = block_rows // LANES
    return (d * 127 * 127 + 1) * rows < 2 ** 31


def reduce_path(int8_mode: bool, scaled: bool, d: int, block_rows: int,
                strips: int, strip_outputs: bool) -> str:
    """The reduce path the scan takes: "packed", "packed_scaled",
    "int8_general" or "f32" (the reference's `last_path` names)."""
    if int8_mode and scaled:
        return "packed_scaled"
    if int8_mode:
        fits = _packed_fits(d, block_rows // strips if strip_outputs
                            else block_rows)
        return "packed" if fits else "int8_general"
    return "f32"


def scan_sheet_plain(corpus: torch.Tensor, queries: torch.Tensor,
                     inv_norms: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], *,
                     valid_n: Optional[int], block_rows: int, mode: str,
                     strips: int, strip_outputs: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the scan kernel, the reference's
    `_scan_kernel` step by step. corpus (nb*block_rows, d) with queries
    (Q, d) of the same dtype family, ``mode`` the `reduce_path` ->
    (vals (nb, Q, bins_out) f32, ids (nb, Q, bins_out) int32)."""
    n, d = corpus.shape
    qn = queries.shape[0]
    nb = n // block_rows
    dev = corpus.device
    bs = block_rows // strips
    rows_total = block_rows // (LANES * strips if strip_outputs else LANES)
    bins_out = LANES * strips if strip_outputs else LANES
    vals_out = torch.empty((nb, qn, bins_out), dtype=torch.float32,
                           device=dev)
    ids_out = torch.empty((nb, qn, bins_out), dtype=torch.int32, device=dev)
    lane = torch.arange(LANES, dtype=torch.int32, device=dev)[None, :]
    sentinel = -(d * 127 * 127 + 1)
    row_bits = max(1, (rows_total - 1).bit_length())
    rmask = (1 << row_bits) - 1

    def decode_scaled(m):
        local_row = (rows_total - 1) - (m & rmask)
        keyc = m & ~rmask
        b2 = keyc ^ ((keyc >> 31) & 0x7FFFFFFF)
        dead = m <= (_INT_MIN | rmask)
        return torch.where(dead, NEG, b2.view(torch.float32)), local_row

    for i in range(nb):
        best = best_row = None
        for s in range(strips):
            r0 = i * block_rows + s * bs
            scores = dot_scores(queries, corpus[r0:r0 + bs])  # (Q, bs)
            valid = None
            if valid_n is not None:
                col = r0 + torch.arange(bs, device=dev)
                valid = (col < valid_n)[None, :]
            if mask is not None:
                m2 = mask[r0:r0 + bs][None, :]
                valid = m2 if valid is None else valid & m2
            row = torch.arange(bs // LANES, dtype=torch.int32,
                               device=dev)[None, :, None]
            if not strip_outputs:
                row = row + s * (bs // LANES)
            seg = slice(s * LANES, (s + 1) * LANES)
            id_base = lane + (s * bs if strip_outputs else 0) \
                + i * block_rows

            if mode == "packed":
                sv = scores if valid is None else \
                    torch.where(valid, scores, sentinel)
                s3 = sv.reshape(qn, bs // LANES, LANES)
                m = torch.amax(s3 * rows_total + (rows_total - 1 - row),
                               dim=1)
                if strip_outputs or s == strips - 1:
                    if not strip_outputs and best is not None:
                        m = torch.maximum(best, m)
                    v = torch.div(m, rows_total, rounding_mode="floor")
                    local_row = (rows_total - 1) - (m - v * rows_total)
                    cols = seg if strip_outputs else slice(0, LANES)
                    vals_out[i, :, cols] = torch.where(v <= sentinel, NEG,
                                                       v.float())
                    ids_out[i, :, cols] = local_row * LANES + id_base
                else:
                    best = m if best is None else torch.maximum(best, m)
            elif mode == "packed_scaled":
                invr = inv_norms[r0:r0 + bs][None, :]
                b = (scores.float() * invr).view(torch.int32)
                key = (b ^ ((b >> 31) & 0x7FFFFFFF)) & ~rmask
                if valid is not None:
                    key = torch.where(valid, key, _INT_MIN)
                k3 = key.reshape(qn, bs // LANES, LANES)
                m = torch.amax(k3 | ((rows_total - 1 - row) & rmask), dim=1)
                if strip_outputs or s == strips - 1:
                    if not strip_outputs and best is not None:
                        m = torch.maximum(best, m)
                    v, local_row = decode_scaled(m)
                    cols = seg if strip_outputs else slice(0, LANES)
                    vals_out[i, :, cols] = v
                    ids_out[i, :, cols] = local_row * LANES + id_base
                else:
                    best = m if best is None else torch.maximum(best, m)
            else:
                sc = scores.float()
                if inv_norms is not None:
                    sc = sc * inv_norms[r0:r0 + bs][None, :]
                if valid is not None:
                    sc = torch.where(valid, sc, NEG)
                s3 = sc.reshape(qn, bs // LANES, LANES)
                m = torch.amax(s3, dim=1)
                hit = s3 == m[:, None, :]
                local_row = torch.amin(
                    torch.where(hit, row, rows_total), dim=1
                ).to(torch.int32)
                if strip_outputs:
                    vals_out[i, :, seg] = m
                    ids_out[i, :, seg] = local_row * LANES + id_base
                    continue
                if best is None:
                    best, best_row = m, local_row
                else:
                    better = m > best
                    best_row = torch.where(better, local_row, best_row)
                    best = torch.maximum(m, best)
                if s == strips - 1:
                    vals_out[i] = best
                    ids_out[i] = best_row * LANES + id_base
    return vals_out, ids_out


def scan_sheet(corpus: torch.Tensor, queries: torch.Tensor,
               inv_norms: Optional[torch.Tensor],
               mask: Optional[torch.Tensor], *,
               valid_n: Optional[int], block_rows: int, mode: str,
               strips: int, strip_outputs: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: the candidate sheet of `scan_sheet_plain`, from
    the CUDA kernel `scan_route` names on a CUDA corpus (counted in
    `route_launches`), from the plain version on a CPU corpus.
    ``corpus`` may be a column slice of a wider table (row stride > d);
    its rows are a multiple of ``block_rows``."""
    if corpus.device.type == "cpu":
        return scan_sheet_plain(corpus, queries, inv_norms, mask,
                                valid_n=valid_n, block_rows=block_rows,
                                mode=mode, strips=strips,
                                strip_outputs=strip_outputs)
    if corpus.device.type != "cuda":
        raise ValueError(f"scan_sheet: unsupported device {corpus.device}")
    n, d = corpus.shape
    qn = queries.shape[0]
    nseg = strips if strip_outputs else 1
    nb = n // block_rows
    int8_mode = corpus.dtype == torch.int8
    if corpus.dtype not in (torch.int8, torch.bfloat16, torch.float32):
        raise TypeError(f"scan_sheet: corpus dtype {corpus.dtype}")
    if corpus.stride(1) != 1 or n % block_rows or block_rows % (LANES * nseg):
        raise ValueError("scan_sheet: corpus must be row-major with rows a "
                         "multiple of block_rows = k*128*segments")
    if mode not in _MODES or (mode == "f32") == int8_mode:
        raise ValueError(f"scan_sheet: reduce path {mode!r} does not take "
                         f"a {corpus.dtype} corpus")
    if int8_mode:
        if queries.dtype != torch.int8:
            raise TypeError("scan_sheet: int8 corpus needs int8 queries")
        if d % 4 or corpus.stride(0) % 4 or corpus.data_ptr() % 4:
            raise ValueError("scan_sheet: int8 rows must be 4-byte aligned")
    queries = queries.contiguous()
    if int8_mode and queries.data_ptr() % 4:
        raise ValueError("scan_sheet: int8 queries must be 4-byte aligned")
    route = scan_route(corpus.dtype, queries.dtype, d, corpus.stride(0),
                       corpus.data_ptr(), queries.data_ptr())
    if route == "fused_scan":
        queries = queries.float()  # the CUDA-core kernel stages f32 queries
    if queries.shape[1] != d or queries.device != corpus.device:
        raise ValueError("scan_sheet: queries must be (Q, d) on the corpus "
                         "device")
    if mode == "packed_scaled" and inv_norms is None:
        raise ValueError("scan_sheet: packed_scaled needs per-row scales")
    if mode == "packed" and not _packed_fits(d, block_rows // nseg):
        raise ValueError("scan_sheet: packed keys would overflow int32")
    for name, t in (("inv_norms", inv_norms), ("mask", mask)):
        if t is not None and (t.device != corpus.device or t.dim() != 1
                              or t.shape[0] != n or not t.is_contiguous()):
            raise ValueError(f"scan_sheet: {name} must be a contiguous "
                             f"({n},) tensor on the corpus device")
    if inv_norms is not None and inv_norms.dtype != torch.float32:
        raise TypeError("scan_sheet: inv_norms must be float32")
    if mask is not None and mask.dtype != torch.bool:
        raise TypeError("scan_sheet: mask must be bool")
    bins_out = LANES * nseg
    vals = torch.empty((nb, qn, bins_out), dtype=torch.float32,
                       device=corpus.device)
    ids = torch.empty((nb, qn, bins_out), dtype=torch.int32,
                      device=corpus.device)
    if nb == 0 or qn == 0:
        return vals, ids
    launch("fused_scan_launch", corpus.device,
           ptr(corpus), _DTYPE_CODES[route, corpus.dtype], corpus.stride(0),
           ptr(queries), qn, d, ptr(inv_norms), ptr(mask),
           -1 if valid_n is None else int(valid_n),
           nb, block_rows, nseg, _MODES[mode], ptr(vals), ptr(ids))
    scan_sheet.launches += 1
    route_launches[route] += 1
    return vals, ids


scan_sheet.launches = 0


def fused_scan_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    *,
    bins: int = LANES,
    block_rows: int = 8192,
    valid_n: Optional[int] = None,
    prefix_dim: Optional[int] = None,
    inv_norms: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    approx_sheet: bool = False,
    select: bool = True,
    strips: int = 1,
    strip_outputs: bool = False,
    q_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates via the fused scan. Returns (vals (Q, k) f32 with
    -inf in empty slots, ids (Q, k) int32), or with ``select=False`` the
    raw (Q, nb*bins_out) candidate sheet. ``approx_sheet`` selects the
    same exact top-k (the reference's approx_max_k is exact on CPU)."""
    if bins != LANES:
        raise ValueError(
            f"bins is fixed at {LANES} (lane binning); tune candidate "
            f"density via block_rows instead")
    n, d = corpus.shape
    q_count = queries.shape[0]
    int8_mode = corpus.dtype == torch.int8

    # the (nb, Q, bins) sheets are chunked over the query axis beyond the
    # byte budget, as the reference does
    if select:
        nb_est = cdiv(n, block_rows)
        bo_est = LANES * strips if strip_outputs else LANES
        if 8 * nb_est * q_count * bo_est > _SHEET_BYTES_BUDGET:
            step = max(q_block or 1024, 128)
            qc = max(step, (_SHEET_BYTES_BUDGET // (8 * nb_est * bo_est))
                     // step * step)
            if qc < q_count:
                fused_scan_topk.last_chunk = qc
                vs, ids = [], []
                for s in range(0, q_count, qc):
                    v, i = fused_scan_topk(
                        corpus, queries[s:s + qc], k, bins=bins,
                        block_rows=block_rows, valid_n=valid_n,
                        prefix_dim=prefix_dim, inv_norms=inv_norms,
                        mask=mask, approx_sheet=approx_sheet,
                        select=True, strips=strips,
                        strip_outputs=strip_outputs,
                        q_block=q_block if q_block and q_block < qc
                        else None)
                    vs.append(v)
                    ids.append(i)
                return torch.cat(vs), torch.cat(ids)

    # q_block only tiles the reference's grid; the CUDA kernel tiles the
    # query axis itself, so it changes nothing but the padding
    q_orig = q_count
    if q_block is not None and q_block < q_count:
        nq = cdiv(q_count, q_block)
        if nq * q_block != q_count:
            queries = torch.nn.functional.pad(
                queries, (0, 0, 0, nq * q_block - q_count))
            q_count = nq * q_block

    # prefix scoring: load only the first ceil(prefix/128)*128 columns and
    # zero the query tail so the dot equals the prefix dot
    d_load = d
    if prefix_dim is not None and prefix_dim < d:
        d_load = min(d, round_up(prefix_dim, 128))
        queries = queries[:, :d_load]
        if prefix_dim < d_load:
            col = torch.arange(d_load, device=queries.device)
            queries = torch.where(col[None, :] < prefix_dim, queries,
                                  torch.zeros((), dtype=queries.dtype,
                                              device=queries.device))

    nb = cdiv(n, block_rows)
    padded = nb * block_rows
    if padded != n:
        if corpus.numel() * corpus.element_size() > 256 * 1024 * 1024:
            logging.getLogger("rag_application_tpu_torch.ops").warning(
                "fused_scan_topk: corpus rows (%d) not a multiple of "
                "block_rows (%d) — padding copies the %.1f GiB table; "
                "align the index capacity to avoid the transient",
                n, block_rows,
                corpus.numel() * corpus.element_size() / 2 ** 30)
        corpus = torch.nn.functional.pad(corpus, (0, 0, 0, padded - n))
        if inv_norms is not None:
            inv_norms = torch.nn.functional.pad(inv_norms, (0, padded - n))
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, padded - n))
        if valid_n is None:
            valid_n = n

    if block_rows % (strips * LANES):
        raise ValueError(
            f"block_rows {block_rows} not divisible by strips*{LANES}")
    path = reduce_path(int8_mode, inv_norms is not None, d_load, block_rows,
                       strips, strip_outputs)
    fused_scan_topk.last_path = path
    bins_out = LANES * strips if strip_outputs else LANES

    vals, idx = scan_sheet(
        corpus[:, :d_load], queries,
        inv_norms.float().contiguous() if inv_norms is not None else None,
        mask.contiguous() if mask is not None else None,
        valid_n=valid_n, block_rows=block_rows,
        mode=path,
        strips=strips, strip_outputs=strip_outputs)

    sheet_vals = vals.permute(1, 0, 2).reshape(q_count, nb * bins_out)
    sheet_idx = idx.permute(1, 0, 2).reshape(q_count, nb * bins_out)
    if q_orig != q_count:
        sheet_vals = sheet_vals[:q_orig]
        sheet_idx = sheet_idx[:q_orig]
    if not select:
        return sheet_vals, sheet_idx
    k_eff = min(k, nb * bins_out)
    top, pos = stable_topk(sheet_vals, k_eff)
    out_idx = torch.gather(sheet_idx, -1, pos)
    top = torch.where(top <= NEG, float("-inf"), top)
    return top, out_idx
