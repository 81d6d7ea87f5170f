"""Where the tensor-core scan kernels' time goes, on the card.

    python3 -m rag_application_tpu_torch.kernels.scan_study

1. The `mma.sync` peaks of the card, int8 `m16n8k32`, bf16 `m16n8k16`
   and tf32 `m16n8k8`: a kernel that issues only independent products on
   register fragments (132 x k blocks of 8 or 16 warps), in TOP/s and
   TFLOP/s.
2. Ablations of `csrc/fused_scan_int8.cu` (`ABLATIONS`), of
   `csrc/fused_scan_bf16.cu` (`ABLATIONS_BF16`) and of
   `csrc/fused_scan_tf32.cu` (`ABLATIONS_TF32`): the source is copied
   with one part cut or changed, each copy built by nvcc into
   `build/scan_study/`, checked against `scan_sheet_plain` where it still
   computes the scan, and timed at its main shape (int8 packed,
   1,048,576 x 768; the cascade's bf16 prefix-128 scan with per-row
   scales, 1,048,576 x 128 of a 768-wide table; an f32 corpus of 262,144
   x 128 with f32 queries and per-row scales; all 8192 queries, block
   16384), built copies in turns (forward, then backward). An ablation
   that cuts work is not a scan: it bounds what that work costs.

Prints one line per measurement and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

from . import build as kb

OUT = os.path.join(os.path.dirname(kb.BUILD_DIR), "scan_study")

PEAK_SRC = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <int T>
__global__ void peak(int iters, int* out) {
  int acc[T][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                   threadIdx.x * 7u};
  uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(acc[t][0]), "+r"(acc[t][1]), "+r"(acc[t][2]), "+r"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int T>
__global__ void peak_bf16(int iters, int* out) {
  float acc[T][4] = {};
  // bf16 pairs of small finite values, so no sum leaves the normal range
  uint32_t a[4] = {0x3c003b80u + (threadIdx.x & 7), 0x3b803c00u, 0xbc003b80u,
                   0x3b80bc00u};
  uint32_t b0 = 0x3c00bb80u + (threadIdx.x & 3), b1 = 0xbb803c00u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]), "+f"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_int(s);
}
template <int T>
__global__ void peak_tf32(int iters, int* out) {
  float acc[T][4] = {};
  // small finite TF32 values, so no sum leaves the normal range
  uint32_t a[4] = {0x3f800000u + ((threadIdx.x & 7) << 13), 0x3f000000u,
                   0xbf800000u, 0x3e800000u};
  uint32_t b0 = 0x3f000000u + ((threadIdx.x & 3) << 13), b1 = 0xbf000000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < T; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]), "+f"(acc[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0;
#pragma unroll
  for (int t = 0; t < T; ++t) s += acc[t][0] + acc[t][1] + acc[t][2] + acc[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_int(s);
}
// KIND: 0 s8 m16n8k32, 1 bf16 m16n8k16, 2 tf32 m16n8k8
template <int T, int KIND>
void run(int warps, int per_sm) {
  int* out;
  const int blocks = 132 * per_sm, threads = 32 * warps, iters = 4096;
  cudaMalloc(&out, sizeof(int) * blocks * threads);
  auto kernel = KIND == 2 ? peak_tf32<T> : KIND == 1 ? peak_bf16<T> : peak<T>;
  kernel<<<blocks, threads>>>(16, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<blocks, threads>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const int k = KIND == 2 ? 8 : KIND == 1 ? 16 : 32;
  const double ops = 2.0 * 16 * 8 * k * T * double(iters) * warps * blocks;
  printf("mma.sync %s m16n8k%d peak: %d products in flight a warp, %d warps "
         "x %d blocks a SM: %.1f %s\n",
         KIND == 2 ? "tf32" : KIND == 1 ? "bf16" : "s8", k, T, warps, per_sm,
         ops / ms / 1e9, KIND ? "TFLOP/s" : "TOP/s");
  cudaFree(out);
}
int main() {
  run<16, 0>(8, 1);
  run<16, 0>(8, 2);
  run<16, 0>(16, 2);
  run<4, 0>(8, 1);
  run<16, 1>(8, 1);
  run<16, 1>(8, 2);
  run<16, 1>(16, 2);
  run<8, 1>(8, 1);
  run<4, 1>(8, 1);
  run<8, 1>(4, 1);
  run<16, 2>(8, 1);
  run<16, 2>(16, 2);
  run<8, 2>(8, 1);
  run<4, 2>(8, 1);
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""

_B_FRAGS = """      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4("""
_A_FRAGS = """        uint32_t a[4];
        ldmatrix_x4("""
_KSTEP = "#pragma unroll\n    for (int ks = 0; ks < KC / 32; ++ks) {\n"
_NO_FRAGS = [  # operands of each chunk's first k-step only
    (_KSTEP, "    uint32_t b[4][2], aa[MT][4];\n" + _KSTEP),
    (_B_FRAGS, _B_FRAGS.replace("      uint32_t b[4][2];\n", "").replace(
        "        ldmatrix_x4(", "        if (ks == 0) ldmatrix_x4(")),
    (_A_FRAGS, "        uint32_t (&a)[4] = aa[mt];\n"
               "        if (ks == 0) ldmatrix_x4("),
]
_NO_LOADS = [("    if (lr < rows_total) {\n      load(lr, lkc, (t + STAGES",
              "    if (false) {\n      load(lr, lkc, (t + STAGES")]
_NO_FOLD = [("            const int sv = valid ? s : sentinel;\n"
             "            key[mt][nt][i] = max(key[mt][nt][i], sv * rows_total"
             " + tie);",
             "            key[mt][nt][i] = max(key[mt][nt][i], s);")]

_NO_FOLD_BF16 = [("""        float v = acc[mt][nt][i];
        if (scale != nullptr) v = __fmul_rn(v, sc[h]);
        if (CHECKED && !((vbits >> (nt * 2 + h)) & 1)) v = NEG;
        if (v > bval[mt][nt][i]) {
          bval[mt][nt][i] = v;
          if constexpr (RT == MT)
            brow[mt][nt][i] = r;
          else
            srow[((mt * 4 + nt) * 4 + i) * THREADS] = r;
        }
""", """        bval[mt][nt][i] = fmaxf(bval[mt][nt][i], acc[mt][nt][i]);
""")]
_NO_128 = [("if (db <= KC && (q_count + 127) / 128 * segs >= sms)",
            "if (false)")]
_NO_64 = [("if ((q_count + 63) / 64 * segs >= sms) return", "if (false) return")]

# name -> (source edits, still the scan?)
ABLATIONS = {
    "as built": ([], True),
    "128-byte chunks, 4 stages": (
        [("constexpr int KC = 256;", "constexpr int KC = 128;"),
         ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")], True),
    "no packed fold (key = max(key, score))": (_NO_FOLD, False),
    "no ring loads after the prologue": (_NO_LOADS, False),
    "operands of each chunk's first k-step only": (_NO_FRAGS, False),
    "neither operands nor fold": (_NO_FRAGS + _NO_FOLD, False),
    "products and barriers only": (_NO_FRAGS + _NO_FOLD + _NO_LOADS, False),
}


# the bf16 kernel's K loop is the int8 kernel's, one level deeper
_NO_FRAGS_BF16 = [
    _NO_FRAGS[0], _NO_FRAGS[1],
    ("          uint32_t a[4];\n          ldmatrix_x4(",
     "          uint32_t (&a)[4] = aa[mt];\n"
     "          if (ks == 0) ldmatrix_x4("),
]
ABLATIONS_BF16 = {
    "as built": ([], True),
    "4-stage ring": ([("constexpr int STAGES = 3;",
                       "constexpr int STAGES = 4;")], True),
    "64-query tiles, A fragments and row groups in registers": (
        _NO_128, True),
    "32-query tiles": (_NO_128 + _NO_64, True),
    "no fold (bval = max(bval, score))": (_NO_FOLD_BF16, False),
    "no ring loads after the prologue": (_NO_LOADS, False),
    "operands of each chunk's first k-step only": (_NO_FRAGS_BF16, False),
    "neither operands nor fold": (_NO_FRAGS_BF16 + _NO_FOLD_BF16, False),
    "products and barriers only": (
        _NO_FRAGS_BF16 + _NO_FOLD_BF16 + _NO_LOADS, False),
}

# the split-TF32 kernel (f32 corpus): its split, and its K loop's operands
# read at each chunk's first k-step only
_CVT_SPLIT = [("  return (x + 0x1000u) & 0xffffe000u;",
               "  uint32_t r;\n"
               "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : "
               "\"f\"(__uint_as_float(x)));\n  return r;")]
_TRUNC_SMALL = [("""  small = tf32_rna(__float_as_uint(__uint_as_float(x) -
                                   __uint_as_float(big)));""",
                 "  small = __float_as_uint(__uint_as_float(x) - "
                 "__uint_as_float(big));")]
_NO_FRAGS_TF32 = [
    (_KSTEP + "      uint32_t b[4][2];\n",
     "    uint32_t b[4][2], aa[MT][2][4];\n" + _KSTEP),
    ("      for (int np = 0; np < 2; ++np) {\n        uint32_t x[4];",
     "      for (int np = 0; np < 2 && ks == 0; ++np) {\n        uint32_t x[4];"),
    ("""          uint32_t ab[4], as[4];
          const uint32_t a = swz<QKC>(a_row + 16 * mt, 2 * ks + a_hi);
          ldmatrix_x4(ab, qb + a);
          ldmatrix_x4(as, qb + QTILE + a);""",
     """          uint32_t (&ab)[4] = aa[mt][0], (&as)[4] = aa[mt][1];
          const uint32_t a = swz<QKC>(a_row + 16 * mt, 2 * ks + a_hi);
          if (ks == 0) ldmatrix_x4(ab, qb + a), ldmatrix_x4(as, qb + QTILE + a);"""),
]
_NO_FOLD_TF32 = [("""        float v = acc[mt][nt][i];
        if (scale != nullptr) v = __fmul_rn(v, sc[h]);
        if (CHECKED && !((vbits >> (nt * 2 + h)) & 1)) v = NEG;
        if (v > bval[mt][nt][i]) {
          bval[mt][nt][i] = v;
          brow[mt][nt][i] = r;
        }
""", """        bval[mt][nt][i] = fmaxf(bval[mt][nt][i], acc[mt][nt][i]);
""")]
_ONE_PRODUCT = [("""            mma_tf32(acc[mt][nt], as, bb[nt][0], bb[nt][1]);
            mma_tf32(acc[mt][nt], ab, bs[nt][0], bs[nt][1]);
""", "")]
ABLATIONS_TF32 = {
    "as built": ([], True),
    "split by cvt.rna.tf32.f32": (_CVT_SPLIT, True),
    "small left to the tensor core's truncation": (_TRUNC_SMALL, True),
    "32-query tiles": ([("const bool wide = (q_count + 63) / 64 * segs >= "
                         "sms;", "const bool wide = false;")], True),
    "one TF32 product a term (big.big)": (_ONE_PRODUCT, False),
    "no fold (bval = max(bval, score))": (_NO_FOLD_TF32, False),
    "no ring loads after the prologue": (_NO_LOADS, False),
    "operands (and so the corpus split) of each chunk's first k-step only": (
        _NO_FRAGS_TF32, False),
}

# study -> (source in csrc/, its entry function, ablations)
STUDIES = {
    "int8": ("fused_scan_int8.cu", "fused_scan_int8", ABLATIONS),
    "bf16": ("fused_scan_bf16.cu", "fused_scan_bf16", ABLATIONS_BF16),
    "tf32": ("fused_scan_tf32.cu", "fused_scan_tf32", ABLATIONS_TF32),
}


def variant_source(source, entry, edits) -> str:
    with open(os.path.join(kb.CSRC, source)) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"scan_study: edit does not apply to {source}:"
                               f" {old[:60]!r}")
        src = src.replace(old, new)
    return src.replace(f"cudaError_t {entry}(", 'extern "C" int study_launch(')


def build_all():
    """Build the peak probe and every ablation in parallel."""
    os.makedirs(OUT, exist_ok=True)
    exe = kb.nvcc()
    jobs = {}
    with open(os.path.join(OUT, "peak.cu"), "w") as f:
        f.write(PEAK_SRC)
    jobs["peak"] = [exe, *kb.ARCH, "-O3", "-o", os.path.join(OUT, "peak"),
                    os.path.join(OUT, "peak.cu")]
    for study, (source, entry, ablations) in STUDIES.items():
        for i, (name, (edits, _)) in enumerate(ablations.items()):
            src = os.path.join(OUT, f"{study}{i}.cu")
            with open(src, "w") as f:
                f.write(variant_source(source, entry, edits))
            jobs[f"{study}: {name}"] = [
                exe, *kb.NVCC_FLAGS, "-shared", "-o",
                os.path.join(OUT, f"{study}{i}.so"), src]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in jobs.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used " in ln]
        spills = sum(int(ln.split(" bytes spill stores")[0].split()[-1])
                     for ln in log.splitlines() if "spill stores" in ln)
        if regs:
            print(f"[build] {name}: {', '.join(regs)}; {spills} bytes of "
                  f"spill stores", flush=True)


def time_study(study, launchers, is_scan, check, nb, ops, unit):
    """Check (on 8 blocks) and time (on ``nb``) every built copy of one
    study, in turns forward then backward; one line per copy."""
    import torch

    names = list(launchers)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        run = launchers[name]
        out = run(8)
        torch.cuda.synchronize()
        if is_scan[name]:
            check(name, *out)
        run(nb)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run(nb)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / 5)
    for name, ts in times.items():
        tag = "holds to plain" if is_scan[name] else "not the scan"
        print(f"{study}: {name}: {' / '.join(f'{t:.3f}' for t in ts)} ms "
              f"({tag}; {ops / min(ts) / 1e9:.0f} {unit})", flush=True)


def main() -> int:
    import torch

    from ..ops import fused_topk as ft
    from ..ops.quant import quantize_int8

    if not torch.cuda.is_available():
        print("scan_study: CUDA is not available", file=sys.stderr)
        return 2
    build_all()
    print(subprocess.run([os.path.join(OUT, "peak")], capture_output=True,
                         text=True, check=True).stdout, end="", flush=True)

    n, d, q, block = 1 << 20, 768, 8192, 16384
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = torch.exp(-0.003 * torch.arange(d, device=dev))
    x = torch.randn((n, d), generator=gen, device=dev) * scale
    x /= torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    xq = torch.randn((q, d), generator=gen, device=dev)
    rows_total = block // 128
    nb = n // block
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream

    def launchers(study, argtypes, call):
        """name -> run(blocks) -> (vals, ids) for each copy of a study."""
        out = {}
        for k, name in enumerate(STUDIES[study][2]):
            lib = ctypes.CDLL(os.path.join(OUT, f"{study}{k}.so"))
            lib.study_launch.restype = i
            lib.study_launch.argtypes = argtypes

            def run(blocks, lib=lib):
                vals = torch.empty((blocks, q, 128), device=dev)
                ids = torch.empty((blocks, q, 128), dtype=torch.int32,
                                  device=dev)
                rc = call(lib.study_launch, blocks, vals, ids)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
                return vals, ids
            out[name] = run
        return out

    kw = dict(valid_n=None, block_rows=block, strips=1, strip_outputs=False)

    # int8 packed, full depth
    corpus = quantize_int8(x)
    q8 = quantize_int8(xq)
    pv, pi = ft.scan_sheet_plain(corpus[:8 * block], q8, None, None,
                                 mode="packed", **kw)

    def check_int8(name, vals, ids):
        if not (torch.equal(vals.view(torch.int32), pv.view(torch.int32))
                and torch.equal(ids, pi)):
            raise AssertionError(f"int8: {name}: sheet != scan_sheet_plain")

    time_study(
        "int8",
        launchers("int8", [p, ll, p, i, i, p, p, ll, i, i, i, i, i, i, i, p,
                           p, p],
                  lambda fn, blocks, vals, ids: fn(
                      corpus.data_ptr(), d, q8.data_ptr(), q, d, None, None,
                      -1, blocks, block, 1, 0, rows_total,
                      -(d * 127 * 127 + 1),
                      (1 << (rows_total - 1).bit_length()) - 1,
                      vals.data_ptr(), ids.data_ptr(), stream)),
        {name: scan for name, (_, scan) in ABLATIONS.items()},
        check_int8, nb, 2.0 * q * n * d, "TOP/s")
    del corpus, q8, pv, pi

    # the cascade's bf16 prefix-128 scan: unit rows, the prefix's inverse
    # norm as the per-row scale, so scores are cosines of the prefixes
    dp = 128
    cb = x.to(torch.bfloat16)
    inv = 1.0 / torch.linalg.vector_norm(cb[:, :dp].float(), dim=-1)
    qb = (xq[:, :dp] / torch.linalg.vector_norm(xq[:, :dp], dim=-1,
                                                keepdim=True)
          ).to(torch.bfloat16).contiguous()
    del x, xq
    bv, bi = ft.scan_sheet_plain(cb[:8 * block, :dp], qb, inv[:8 * block],
                                 None, mode="f32", **kw)
    atol = 2 * dp * 2.0 ** -24  # d * 2^-24 a side: the order of f32 sums

    def check_bf16(name, vals, ids):
        err = (vals - bv).abs().max().item()
        differ = (ids != bi).float().mean().item()
        if err > atol or differ > 1e-3:
            raise AssertionError(f"bf16: {name}: max abs err {err:.3g} "
                                 f"(atol {atol:.3g}), ids differ {differ:.2e}")

    time_study(
        "bf16",
        launchers("bf16", [p, ll, p, i, i, p, p, ll, i, i, i, i, p, p, p],
                  lambda fn, blocks, vals, ids: fn(
                      cb.data_ptr(), d, qb.data_ptr(), q, dp, inv.data_ptr(),
                      None, -1, blocks, block, 1, rows_total,
                      vals.data_ptr(), ids.data_ptr(), stream)),
        {name: scan for name, (_, scan) in ABLATIONS_BF16.items()},
        check_bf16, nb, 2.0 * q * n * dp, "TFLOP/s")
    del cb, qb, inv, bv, bi

    # the split-TF32 kernel on its own ground: an f32 corpus (unit rows of
    # 128, 262,144 of them), f32 queries, per-row scales in [0.5, 1.5);
    # the rate counts the f32 flops, 2 Q N d (three TF32 products each)
    nf = 262144
    cf = torch.randn((nf, dp), generator=gen, device=dev)
    cf /= torch.linalg.vector_norm(cf, dim=-1, keepdim=True)
    qf = torch.randn((q, dp), generator=gen, device=dev)
    qf /= torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
    invf = torch.rand(nf, generator=gen, device=dev) + 0.5
    fv, fi = ft.scan_sheet_plain(cf[:8 * block], qf, invf[:8 * block], None,
                                 mode="f32", **kw)
    atol_f = 1.5 * atol  # unit rows, scales below 1.5

    def check_tf32(name, vals, ids):
        err = (vals - fv).abs().max().item()
        differ = (ids != fi).float().mean().item()
        if err > atol_f or differ > 1e-3:
            raise AssertionError(f"tf32: {name}: max abs err {err:.3g} "
                                 f"(atol {atol_f:.3g}), ids differ "
                                 f"{differ:.2e}")

    time_study(
        "tf32",
        launchers("tf32", [p, ctypes.c_bool, ll, p, i, i, p, p, ll, i, i, i,
                           i, p, p, p],
                  lambda fn, blocks, vals, ids: fn(
                      cf.data_ptr(), False, dp, qf.data_ptr(), q, dp,
                      invf.data_ptr(), None, -1, blocks, block, 1,
                      rows_total, vals.data_ptr(), ids.data_ptr(), stream)),
        {name: scan for name, (_, scan) in ABLATIONS_TF32.items()},
        check_tf32, nf // block, 2.0 * q * nf * dp, "TFLOP/s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
