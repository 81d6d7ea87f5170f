// Fused similarity scan with lane-bin max reduce, for Hopper (sm_90a).
//
// Replaces: rag_application_tpu/ops/fused_topk.py::_scan_kernel (the Pallas
// TPU kernel launched by fused_scan_topk). For every corpus block and query
// it reduces the (Q, block) score tile to 128 lane bins — bin `lane` holds
// the rows {lane, lane+128, ...} of the block, or of each strip when strips
// emit their own bins — keeping each bin's max and its row (ties toward the
// smaller row), and writes only that (nb, Q, 128*segments) candidate sheet.
// fused_scan_launch is the one entry, and sends each corpus and query type to
// one of three kernels:
//   * int8 corpus, int8 queries (the packed, packed_scaled and general
//     reduce paths): the int8 tensor-core kernel of fused_scan_int8.cu;
//   * bf16 corpus, bf16 queries, rows and pointers on 4-byte boundaries (the
//     general path; the matryoshka cascade's prefix scan): the bf16
//     tensor-core kernel of fused_scan_bf16.cu;
//   * f32 corpus, or f32 queries on a bf16 corpus, which is also where the
//     wrapper sends a bf16 scan whose odd depth, odd row stride or pointer
//     cp.async cannot copy (the general path): the CUDA-core kernel below.
//
// What bounds it on the H100: operations, 2*Q*N*d. No main path reaches the
// kernel below when both operands are bf16, so it stays the simple, exact
// first kernel: rows are upcast to f32 when staged and dotted with fmaf on
// the CUDA cores (67 TFLOP/s f32). One 256-thread block owns one query tile
// of 64 queries and one segment of one corpus block; threads own lanes, each
// keeping the running (max, row) of 8 queries x 4 lanes in registers across
// the segment's row groups, so no score ever leaves registers. Query and
// corpus chunks of 16 elements of depth are staged in shared memory with a
// 20-word row pitch, which makes the 16-byte shared loads of a warp's 32
// different corpus rows conflict-free. The query tile index varies fastest
// in the grid, so the blocks in flight share one or two corpus blocks and
// the corpus is read from device memory about once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int QT = 64;        // queries per thread block
constexpr int TQ = 8;         // queries per thread: tq*TQ + i
constexpr int TL = 4;         // lanes per thread: tl + 32*j
constexpr int THREADS = 256;  // (QT / TQ) warps x 32 lane groups
constexpr int KW = 16;        // elements of depth per staged chunk
constexpr int PITCH = 20;     // shared row pitch in words
constexpr float NEG = -3.0e38f;

enum Mode { PACKED = 0, PACKED_SCALED = 1, GENERAL = 2 };

// One element of a staged row as f32.
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float as_f32(float v) { return v; }

template <typename C, typename Q>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const C* __restrict__ corpus, long long ld,
            const Q* __restrict__ queries, int q_count, int d,
            const float* __restrict__ inv, const uint8_t* __restrict__ mask,
            long long valid_n, int block_rows, int nseg, int rows_total,
            float* __restrict__ vals, int* __restrict__ ids) {
  __shared__ __align__(16) float qs[QT * PITCH];
  __shared__ __align__(16) float cs[LANES * PITCH];

  const int tid = threadIdx.x;
  const int tl = tid & 31;
  const int tq = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int blk = blockIdx.y / nseg;
  const int seg = blockIdx.y % nseg;
  const long long seg_off = static_cast<long long>(seg) * rows_total * LANES;
  const long long seg_row0 =
      static_cast<long long>(blk) * block_rows + seg_off;

  float bval[TQ][TL];  // running max
  int brow[TQ][TL];    // its row group
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      bval[i][j] = __int_as_float(0xff800000);
      brow[i][j] = 0;
    }

  for (int r = 0; r < rows_total; ++r) {
    const long long row0 = seg_row0 + static_cast<long long>(r) * LANES;
    float acc[TQ][TL];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TL; ++j) acc[i][j] = 0.0f;

    for (int kw0 = 0; kw0 < d; kw0 += KW) {
      for (int w = tid; w < QT * KW; w += THREADS) {
        const int qi = w / KW, kw = w % KW, q = q0 + qi, kk = kw0 + kw;
        float v = 0.0f;
        if (q < q_count && kk < d)
          v = as_f32(queries[static_cast<long long>(q) * d + kk]);
        qs[qi * PITCH + kw] = v;
      }
      for (int w = tid; w < LANES * KW; w += THREADS) {
        const int li = w / KW, kw = w % KW, kk = kw0 + kw;
        float v = 0.0f;
        if (kk < d) v = as_f32(corpus[(row0 + li) * ld + kk]);
        cs[li * PITCH + kw] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < KW; kw += 4) {
        float4 b[TL];
#pragma unroll
        for (int j = 0; j < TL; ++j)
          b[j] = *reinterpret_cast<const float4*>(&cs[(tl + 32 * j) * PITCH + kw]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(&qs[(tq * TQ + i) * PITCH + kw]);
#pragma unroll
          for (int j = 0; j < TL; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
          }
        }
      }
      __syncthreads();
    }

    // fold this row group into the running bin state
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      const long long row = row0 + tl + 32 * j;
      const bool valid = (valid_n < 0 || row < valid_n) &&
                         (mask == nullptr || mask[row] != 0);
      const float scale = (inv != nullptr) ? inv[row] : 1.0f;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        float v = acc[i][j];
        if (inv != nullptr) v = __fmul_rn(v, scale);
        if (!valid) v = NEG;
        if (v > bval[i][j]) {
          bval[i][j] = v;
          brow[i][j] = r;
        }
      }
    }
  }

  const long long id_base = seg_off + static_cast<long long>(blk) * block_rows;
  const int bins_out = nseg * LANES;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int q = q0 + tq * TQ + i;
    if (q >= q_count) continue;
    const long long out =
        (static_cast<long long>(blk) * q_count + q) * bins_out + seg * LANES;
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      const int lane = tl + 32 * j;
      vals[out + lane] = bval[i][j];
      ids[out + lane] = static_cast<int>(
          static_cast<long long>(brow[i][j]) * LANES + lane + id_base);
    }
  }
}

template <typename C, typename Q>
cudaError_t launch(const void* corpus, long long ld, const void* queries,
                   int q_count, int d, const float* inv, const uint8_t* mask,
                   long long valid_n, int nb, int block_rows, int nseg,
                   int rows_total, float* vals, int* ids,
                   cudaStream_t stream) {
  const dim3 grid((q_count + QT - 1) / QT, nb * nseg);
  scan_kernel<C, Q><<<grid, THREADS, 0, stream>>>(
      static_cast<const C*>(corpus), ld, static_cast<const Q*>(queries),
      q_count, d, inv, mask, valid_n, block_rows, nseg, rows_total, vals,
      ids);
  return cudaGetLastError();
}

}  // namespace

// fused_scan_int8.cu: the tensor-core kernel of the int8 reduce paths
cudaError_t fused_scan_int8(const void* corpus, long long ld,
                            const void* queries, int q_count, int d,
                            const float* inv, const uint8_t* mask,
                            long long valid_n, int nb, int block_rows,
                            int nseg, int mode, int rows_total, int sentinel,
                            int rmask, float* vals, int* ids,
                            cudaStream_t stream);

// fused_scan_bf16.cu: the tensor-core kernel of bf16 corpus x bf16 queries
cudaError_t fused_scan_bf16(const void* corpus, long long ld,
                            const void* queries, int q_count, int d,
                            const float* inv, const uint8_t* mask,
                            long long valid_n, int nb, int block_rows,
                            int nseg, int rows_total, float* vals, int* ids,
                            cudaStream_t stream);

// corpus_dtype: 0 int8 (queries int8), 1 bf16 (queries f32), 2 f32 (queries
// f32), 3 bf16 (queries bf16; refused unless d and ld are even and both
// pointers 4-byte aligned). ld and d count elements. mode: 0 packed, 1
// packed_scaled, 2 general. valid_n < 0: no bound. inv / mask may be null.
// Returns a cudaError_t (0 = launched).
extern "C" int fused_scan_launch(const void* corpus, int corpus_dtype,
                                 long long ld, const void* queries,
                                 int q_count, int d, const float* inv,
                                 const uint8_t* mask, long long valid_n,
                                 int nb, int block_rows, int nseg, int mode,
                                 float* vals, int* ids, void* stream) {
  if (nb <= 0 || nseg <= 0 || q_count <= 0 || block_rows % (LANES * nseg) ||
      nb * static_cast<long long>(nseg) > 65535)
    return cudaErrorInvalidValue;
  const int rows_total = block_rows / (LANES * nseg);
  auto s = static_cast<cudaStream_t>(stream);
  if (corpus_dtype == 0) {
    if (d % 4 || mode < PACKED || mode > GENERAL ||
        (mode == PACKED_SCALED && inv == nullptr))
      return cudaErrorInvalidValue;
    const int sentinel = -(d * 127 * 127 + 1);
    int row_bits = 1;
    while ((1 << row_bits) - 1 < rows_total - 1) ++row_bits;
    const int rmask = (1 << row_bits) - 1;
    return fused_scan_int8(corpus, ld, queries, q_count, d, inv, mask,
                           valid_n, nb, block_rows, nseg, mode, rows_total,
                           sentinel, rmask, vals, ids, s);
  }
#define SCAN_ARGS corpus, ld, queries, q_count, d, inv, mask, valid_n, nb, \
                  block_rows, nseg, rows_total, vals, ids, s
  if (mode == GENERAL) {
    if (corpus_dtype == 3)
      return fused_scan_bf16(corpus, ld, queries, q_count, d, inv, mask,
                             valid_n, nb, block_rows, nseg, rows_total, vals,
                             ids, s);
    if (corpus_dtype == 1) return launch<__nv_bfloat16, float>(SCAN_ARGS);
    if (corpus_dtype == 2) return launch<float, float>(SCAN_ARGS);
  }
#undef SCAN_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
