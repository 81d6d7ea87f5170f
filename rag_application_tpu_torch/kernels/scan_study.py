"""Where the int8 scan kernel's time goes, on the card.

    python3 -m rag_application_tpu_torch.kernels.scan_study

1. The int8 `mma.sync.m16n8k32` peak of the card: a kernel that issues
   only independent products on register fragments (132 x k blocks of
   8 or 16 warps), in TOP/s.
2. Ablations of `csrc/fused_scan_int8.cu`: the source is copied with
   one part cut or changed (`ABLATIONS`), each copy built by nvcc into
   `build/scan_study/`, checked against `scan_sheet_plain` where it still
   computes the scan, and timed at the main shape (int8 packed,
   1,048,576 x 768, 8192 queries, block 16384), built copies in turns
   (forward, then backward). An ablation that cuts work is not a scan:
   it bounds what that work costs.

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
void run(int warps, int per_sm) {
  int* out;
  const int blocks = 132 * per_sm, threads = 32 * warps, iters = 4096;
  cudaMalloc(&out, sizeof(int) * blocks * threads);
  peak<T><<<blocks, threads>>>(16, out);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  peak<T><<<blocks, threads>>>(iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double ops = 2.0 * 16 * 8 * 32 * T * double(iters) * warps * blocks;
  printf("mma.sync s8 m16n8k32 peak: %d products in flight a warp, %d warps "
         "x %d blocks a SM: %.1f TOP/s\n", T, warps, per_sm, ops / ms / 1e9);
  cudaFree(out);
}
int main() {
  run<16>(8, 1);
  run<16>(8, 2);
  run<16>(16, 2);
  run<4>(8, 1);
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


def variant_source(edits) -> str:
    with open(os.path.join(kb.CSRC, "fused_scan_int8.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"scan_study: edit does not apply: {old[:60]!r}")
        src = src.replace(old, new)
    return src.replace("cudaError_t fused_scan_int8(",
                       'extern "C" int study_launch(')


def build_all():
    """Build the peak probe and every ablation in parallel."""
    os.makedirs(OUT, exist_ok=True)
    exe = kb.nvcc()
    jobs = {}
    with open(os.path.join(OUT, "peak.cu"), "w") as f:
        f.write(PEAK_SRC)
    jobs["peak"] = [exe, *kb.ARCH, "-O3", "-o", os.path.join(OUT, "peak"),
                    os.path.join(OUT, "peak.cu")]
    for i, (name, (edits, _)) in enumerate(ABLATIONS.items()):
        src = os.path.join(OUT, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(variant_source(edits))
        jobs[name] = [exe, *kb.NVCC_FLAGS, "-shared", "-o",
                      os.path.join(OUT, f"v{i}.so"), src]
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, c in jobs.items()}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used " in ln]
        if regs:
            print(f"[build] {name}: {', '.join(regs)}", flush=True)


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
    corpus = quantize_int8(torch.randn((n, d), generator=gen, device=dev)
                           * scale)
    q8 = quantize_int8(torch.randn((q, d), generator=gen, device=dev))
    rows_total = block // 128
    nb = n // block
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def launcher(k):
        lib = ctypes.CDLL(os.path.join(OUT, f"v{k}.so"))
        lib.study_launch.restype = i
        lib.study_launch.argtypes = [p, ll, p, i, i, p, p, ll, i, i, i, i,
                                     i, i, i, p, p, p]

        def run(blocks):
            vals = torch.empty((blocks, q, 128), device=dev)
            ids = torch.empty((blocks, q, 128), dtype=torch.int32,
                              device=dev)
            rc = lib.study_launch(
                corpus.data_ptr(), d, q8.data_ptr(), q, d, None, None, -1,
                blocks, block, 1, 0, rows_total, -(d * 127 * 127 + 1),
                (1 << (rows_total - 1).bit_length()) - 1, vals.data_ptr(),
                ids.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
            return vals, ids
        return run

    kw = dict(valid_n=None, block_rows=block, mode="packed", strips=1,
              strip_outputs=False)
    pv, pi = ft.scan_sheet_plain(corpus[:8 * block], q8, None, None, **kw)
    runs = {name: launcher(k) for k, name in enumerate(ABLATIONS)}
    times = {name: [] for name in ABLATIONS}
    for name in list(ABLATIONS) + list(ABLATIONS)[::-1]:
        run = runs[name]
        vals, ids = run(8)
        torch.cuda.synchronize()
        if ABLATIONS[name][1] and not (
                torch.equal(vals.view(torch.int32), pv.view(torch.int32))
                and torch.equal(ids, pi)):
            raise AssertionError(f"{name}: sheet != scan_sheet_plain")
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
        tag = "bit-equal to plain" if ABLATIONS[name][1] else "not the scan"
        print(f"{name}: {' / '.join(f'{t:.3f}' for t in ts)} ms ({tag}; "
              f"{2.0 * q * n * d / min(ts) / 1e9:.0f} TOP/s)", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
