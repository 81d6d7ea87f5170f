// BM25 exact-rescore match for Hopper (sm_90a).
//
// Replaces: rag_application_tpu/ops/bm25.py::_match_kernel (the Pallas TPU
// kernel launched by bm25_match_scores). For each query q and candidate p,
//   out[q, p] = sum_l dw[r, l] * [dt[r, l] is one of q's valid terms]
// where r is the candidate's doc-major row: cand[q, p] when candidate ids
// are given (the row is read from the table itself, id N being the
// sentinel row), else q * pool + p (rows already gathered). The reference
// kernel emits the per-slot weights and sums over L outside; this kernel
// fuses the sum and writes (Q, pool) directly. Slots are added in order
// l = 0, 1, ..., L-1 (misses add 0), the order the plain version uses, so
// the two agree bit for bit.
//
// What bounds it on the H100: bytes. At the main shape (Q = 8192, pool 16,
// L = 32, T = 32) it reads 0.5 MB of ids, 33.5 MB of doc rows and 1.3 MB
// of query terms and writes 0.5 MB of scores, ~10.7 us at 3.35 TB/s.
//
// What this design does about it:
// - A block owns 128 (query, candidate) rows, one thread each. It reads
//   each candidate's row by id itself, so no gathered copy of the rows is
//   written and read back. The rows are staged into shared memory with
//   cp.async, 16 bytes a lane, neighbouring lanes on neighbouring
//   addresses (a 256-byte packed row is 16 lanes' copies); a warp stages
//   the rows its own threads own.
// - While the copies are in flight, the block sorts each of its queries'
//   valid terms into shared memory (rank by counting), padded with the
//   largest term to a power of two P >= T. A doc term is then tested by a
//   binary search of log2(P) = ceil(log2 T) steps instead of T compares;
//   invalid query slots never enter the array, so they never match.
// - Staged rows are padded to an odd number of 16-byte units, so each
//   thread's 16-byte reads along its own row hit no bank conflict.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;  // rows a block, one thread each

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared layout: ROWS staged rows of `pitch` words (terms at [0, l),
// weights at [lp, lp + l), lp = l rounded up to 4), then nq_max sorted
// term arrays of p = 2^log2p words, then nq_max valid-term counts.
//
// VEC: l % 4 == 0, 16-byte aligned rows (both strides % 4 == 0) -> 16-byte
// copies; else 4-byte copies. LOG2P >= 0: the search's depth at compile
// time (unrolled); -1: log2p at run time.
template <bool VEC, int LOG2P>
__global__ void __launch_bounds__(ROWS)
bm25_match_kernel(const int* __restrict__ dt, long long dt_stride,
                  const float* __restrict__ dw, long long dw_stride,
                  const int* __restrict__ cand, long long n_table,
                  int q_count, int pool, int l, int lp, int pitch,
                  const int* __restrict__ q_terms,
                  const uint8_t* __restrict__ q_valid, int t, int log2p,
                  int nq_max, float* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int p = 1 << (LOG2P >= 0 ? LOG2P : log2p);
  int* rows = smem;                            // ROWS * pitch
  int* sorted = smem + ROWS * pitch;           // nq_max * p
  int* n_valid = sorted + nq_max * p;          // nq_max

  const long long n_rows = static_cast<long long>(q_count) * pool;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const long long row = row0 + threadIdx.x;
  const bool live = row < n_rows;
  const int live_i = live;
  const int qa = static_cast<int>(row0 / pool);
  const int lane = threadIdx.x & 31;
  const int warp_row0 = threadIdx.x & ~31;

  // 1. this thread's table row, then the warp's rows staged by cp.async:
  // `per` copies a row, lane i of the warp's step k takes copy
  // (32 k + i) % per of row (32 k + i) / per, advanced without a division
  long long src = row;
  if (cand != nullptr && live) {
    src = cand[row];
    if (src < 0 || src >= n_table) __trap();  // as an index out of range
  }
  {
    const int half = VEC ? l / 4 : l;  // copies of each half of a row
    const int per = 2 * half;
    const int dr = 32 / per, du = 32 - dr * per;
    int r = lane / per, u = lane - r * per;
    for (int k = 0; k < per; ++k) {
      const long long s = __shfl_sync(0xffffffffu, src, r);
      const int ok = __shfl_sync(0xffffffffu, live_i, r);
      if (ok) {
        int* dst = rows + (warp_row0 + r) * pitch;
        if (VEC) {
          if (u < half)
            cp_async16(dst + 4 * u, dt + s * dt_stride + 4 * u);
          else
            cp_async16(dst + lp + 4 * (u - half),
                       dw + s * dw_stride + 4 * (u - half));
        } else {
          if (u < half)
            cp_async4(dst + u, dt + s * dt_stride + u);
          else
            cp_async4(dst + lp + (u - half), dw + s * dw_stride + (u - half));
        }
      }
      r += dr;
      u += du;
      if (u >= per) {
        u -= per;
        ++r;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. meanwhile, each query's valid terms sorted into `sorted`: a valid
  // slot's rank is the count of valid slots before it in (term, slot)
  // order; the largest also fills the padding up to p
  const long long last = min(n_rows, row0 + ROWS) - 1;
  const int nq = static_cast<int>(last / pool) - qa + 1;
  for (int w = threadIdx.x; w < nq * t; w += ROWS) {
    const int qi = w / t;
    const int j = w - qi * t;
    const int* qt = q_terms + static_cast<long long>(qa + qi) * t;
    const uint8_t* qv = q_valid + static_cast<long long>(qa + qi) * t;
    const int term = qt[j];
    int rank = 0, nv = 0;
#pragma unroll 8
    for (int k = 0; k < t; ++k) {
      const bool v = qv[k] != 0;
      const int o = qt[k];
      nv += v;
      rank += v & ((o < term) | ((o == term) & (k < j)));
    }
    if (j == 0) n_valid[qi] = nv;
    if (qv[j] != 0) {
      int* s = sorted + qi * p;
      s[rank] = term;
      if (rank == nv - 1)
        for (int k = nv; k < p; ++k) s[k] = term;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. the thread's own row: binary search of each doc term, weights
  // added in slot order
  if (!live) return;
  const int qi = static_cast<int>(row / pool) - qa;
  const int* s = sorted + qi * p;
  const bool any = n_valid[qi] > 0;
  const int* trow = rows + threadIdx.x * pitch;
  const float* wrow = reinterpret_cast<const float*>(trow + lp);
  float acc = 0.0f;
#pragma unroll 2
  for (int c = 0; c < lp; c += 4) {
    const int4 tv = *reinterpret_cast<const int4*>(trow + c);
    const float4 wv = *reinterpret_cast<const float4*>(wrow + c);
    const int tt[4] = {tv.x, tv.y, tv.z, tv.w};
    const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= l) break;
      const int x = tt[e];
      int i = 0;  // the last slot holding a term <= x (or slot 0)
      if (LOG2P >= 0) {
#pragma unroll
        for (int b = LOG2P - 1; b >= 0; --b)
          i |= s[i | (1 << b)] <= x ? 1 << b : 0;
      } else {
        for (int h = p >> 1; h > 0; h >>= 1) i |= s[i | h] <= x ? h : 0;
      }
      const bool hit = any & (s[i] == x);
      acc = __fadd_rn(acc, hit ? ww[e] : 0.0f);
    }
  }
  out[row] = acc;
}

using MatchKernel = decltype(&bm25_match_kernel<true, -1>);

// The kernel for a search of log2p steps: unrolled up to T = 64.
template <bool VEC>
MatchKernel pick(int log2p) {
  switch (log2p) {
    case 0: return bm25_match_kernel<VEC, 0>;
    case 1: return bm25_match_kernel<VEC, 1>;
    case 2: return bm25_match_kernel<VEC, 2>;
    case 3: return bm25_match_kernel<VEC, 3>;
    case 4: return bm25_match_kernel<VEC, 4>;
    case 5: return bm25_match_kernel<VEC, 5>;
    case 6: return bm25_match_kernel<VEC, 6>;
    default: return bm25_match_kernel<VEC, -1>;
  }
}

}  // namespace

// Rows r of l int32 terms at dt + r * dt_stride and l f32 weights at
// dw + r * dw_stride (strides in 4-byte words). With cand (Q, pool) int32,
// the row of (q, p) is cand[q, p] in [0, n_table); without it (NULL), row
// q * pool + p. q_terms (Q, t) int32 and q_valid (Q, t) bool, both
// contiguous; out (Q, pool) f32. Returns a cudaError_t (0 = launched).
extern "C" int bm25_match_launch(const int* dt, long long dt_stride,
                                 const float* dw, long long dw_stride,
                                 const int* cand, long long n_table,
                                 int q_count, int pool, int l,
                                 const int* q_terms, const uint8_t* q_valid,
                                 int t, float* out, void* stream) {
  if (q_count <= 0 || pool <= 0 || l <= 0 || t <= 0 || dt_stride < 0 ||
      dw_stride < 0 || (cand != nullptr && n_table <= 0))
    return cudaErrorInvalidValue;
  const long long n_rows = static_cast<long long>(q_count) * pool;
  const long long blocks = (n_rows + ROWS - 1) / ROWS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  int log2p = 0;
  while ((1 << log2p) < t) ++log2p;
  const int p = 1 << log2p;
  const int lp = (l + 3) / 4 * 4;
  // an odd count of 16-byte units a staged row: conflict-free 16-byte reads
  const int pitch = (2 * lp / 4) % 2 ? 2 * lp : 2 * lp + 4;
  // queries touched by one block of ROWS consecutive rows
  const long long nq_span = ROWS / pool + 2;
  const int nq_max = static_cast<int>(nq_span < q_count ? nq_span : q_count);
  const size_t smem = (static_cast<size_t>(ROWS) * pitch +
                       static_cast<size_t>(nq_max) * (p + 1)) * sizeof(int);
  const bool vec =
      l % 4 == 0 && dt_stride % 4 == 0 && dw_stride % 4 == 0 &&
      reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  auto kernel = vec ? pick<true>(log2p) : pick<false>(log2p);
  if (smem > 48 * 1024) {
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), ROWS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      dt, dt_stride, dw, dw_stride, cand, n_table, q_count, pool, l, lp,
      pitch, q_terms, q_valid, t, log2p, nq_max, out);
  return cudaGetLastError();
}
