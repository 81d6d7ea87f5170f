// BM25 exact-rescore match for Hopper (sm_90a).
//
// Replaces: rag_application_tpu/ops/bm25.py::_match_kernel (the Pallas TPU
// kernel launched by bm25_match_scores). For each query q and candidate p,
//   out[q, p] = sum_l dw[q, p, l] * [dt[q, p, l] is one of q's valid terms]
// The reference kernel emits the per-slot weights and sums over L outside;
// this kernel fuses the sum and writes (Q, pool) directly. Slots are added
// in order l = 0, 1, ..., L-1 (misses add 0), the order the plain version
// uses, so the two agree bit for bit.
//
// What bounds it on the H100: bytes. At the main shape (Q = 8192, pool 16,
// L = 32, T = 32) it reads 8192*16*32*8 B = 34 MB of terms and weights,
// about 10 us at 3.35 TB/s; the T-way compares are ~1.3e8 simple ops.
//
// What this design does about it: one thread per (query, candidate) row,
// 128 rows per block. The block first loads the <= T terms (and validity)
// of the queries its rows belong to into shared memory, once, so each
// row's L x T membership test reads the query side from shared memory and
// only its own row from device memory. Term and weight views may be column
// slices of the interleaved doc-major rows (row stride 2L), which spares a
// copy of the gathered rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
bm25_match_kernel(const int* __restrict__ dt, long long dt_stride,
                  const float* __restrict__ dw, long long dw_stride,
                  int q_count, int pool, int l,
                  const int* __restrict__ q_terms,
                  const uint8_t* __restrict__ q_valid, int t,
                  float* __restrict__ out) {
  extern __shared__ int smem[];
  const long long n_rows = static_cast<long long>(q_count) * pool;
  const long long row0 = static_cast<long long>(blockIdx.x) * THREADS;
  const int qa = static_cast<int>(row0 / pool);
  const long long last = min(n_rows, row0 + THREADS) - 1;
  const int nq = static_cast<int>(last / pool) - qa + 1;
  int* terms = smem;                                        // nq * t
  uint8_t* valid = reinterpret_cast<uint8_t*>(smem + nq * t);  // nq * t

  for (int w = threadIdx.x; w < nq * t; w += THREADS) {
    const long long src = static_cast<long long>(qa) * t + w;
    terms[w] = q_terms[src];
    valid[w] = q_valid[src];
  }
  __syncthreads();

  const long long row = row0 + threadIdx.x;
  if (row >= n_rows) return;
  const int qi = static_cast<int>(row / pool) - qa;
  const int* qt = terms + qi * t;
  const uint8_t* qv = valid + qi * t;
  const int* drow = dt + row * dt_stride;
  const float* wrow = dw + row * dw_stride;
  float acc = 0.0f;
  for (int s = 0; s < l; ++s) {
    const int term = drow[s];
    bool hit = false;
    for (int j = 0; j < t; ++j) hit |= (qv[j] != 0) & (qt[j] == term);
    acc = __fadd_rn(acc, hit ? wrow[s] : 0.0f);
  }
  out[row] = acc;
}

}  // namespace

// dt: (Q*pool) rows of l int32 terms at row stride dt_stride; dw likewise
// f32 weights at dw_stride; q_terms (Q, t) int32 and q_valid (Q, t) bool,
// both contiguous; out (Q, pool) f32. Returns a cudaError_t (0 = launched).
extern "C" int bm25_match_launch(const int* dt, long long dt_stride,
                                 const float* dw, long long dw_stride,
                                 int q_count, int pool, int l,
                                 const int* q_terms, const uint8_t* q_valid,
                                 int t, float* out, void* stream) {
  if (q_count <= 0 || pool <= 0 || l <= 0 || t <= 0)
    return cudaErrorInvalidValue;
  const long long n_rows = static_cast<long long>(q_count) * pool;
  const long long blocks = (n_rows + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  // queries touched by one block of THREADS consecutive rows
  const int nq_max = THREADS / pool + 2 < THREADS ? THREADS / pool + 2
                                                  : THREADS;
  const size_t smem = static_cast<size_t>(nq_max) * t * (sizeof(int) + 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  bm25_match_kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      dt, dt_stride, dw, dw_stride, q_count, pool, l, q_terms, q_valid, t,
      out);
  return cudaGetLastError();
}
