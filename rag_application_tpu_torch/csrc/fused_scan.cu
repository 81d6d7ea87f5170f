// Fused similarity scan with lane-bin max reduce, for Hopper (sm_90a): the
// one C entry of the scan kernels.
//
// Replaces: rag_application_tpu/ops/fused_topk.py::_scan_kernel (the Pallas
// TPU kernel launched by fused_scan_topk). For every corpus block and query
// it reduces the (Q, block) score tile to 128 lane bins — bin `lane` holds
// the rows {lane, lane+128, ...} of the block, or of each strip when strips
// emit their own bins — keeping each bin's max and its row (ties toward the
// smaller row), and writes only that (nb, Q, 128*segments) candidate sheet.
// fused_scan_launch is the one entry, and sends each corpus and query type to
// one of three kernels, all on the tensor cores with mma.sync:
//   * int8 corpus, int8 queries (the packed, packed_scaled and general
//     reduce paths): fused_scan_int8.cu;
//   * bf16 corpus, bf16 queries, rows and pointers on 4-byte boundaries (the
//     general path; the matryoshka cascade's prefix scan): fused_scan_bf16.cu;
//   * f32 corpus, or f32 queries on a bf16 corpus, which is also where the
//     wrapper sends a bf16 scan whose odd depth, odd row stride or pointer
//     cp.async cannot copy (the general path): fused_scan_tf32.cu, split TF32
//     products at f32 accuracy.
// What bounds each, and its design, is in its own source.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;

enum Mode { PACKED = 0, PACKED_SCALED = 1, GENERAL = 2 };

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

// fused_scan_tf32.cu: the tensor-core kernel of f32 operands (queries f32)
cudaError_t fused_scan_tf32(const void* corpus, bool corpus_bf16,
                            long long ld, const void* queries, int q_count,
                            int d, const float* inv, const uint8_t* mask,
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
  if (mode == GENERAL) {
    if (corpus_dtype == 3)
      return fused_scan_bf16(corpus, ld, queries, q_count, d, inv, mask,
                             valid_n, nb, block_rows, nseg, rows_total, vals,
                             ids, s);
    if (corpus_dtype == 1 || corpus_dtype == 2)
      return fused_scan_tf32(corpus, corpus_dtype == 1, ld, queries, q_count,
                             d, inv, mask, valid_n, nb, block_rows, nseg,
                             rows_total, vals, ids, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
