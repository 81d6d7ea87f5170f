// Fused similarity scan with lane-bin max reduce, for Hopper (sm_90a).
//
// Replaces: rag_application_tpu/ops/fused_topk.py::_scan_kernel (the Pallas
// TPU kernel launched by fused_scan_topk). For every corpus block and query
// it reduces the (Q, block) score tile to 128 lane bins — bin `lane` holds
// the rows {lane, lane+128, ...} of the block, or of each strip when strips
// emit their own bins — keeping each bin's max and its row (ties toward the
// smaller row), and writes only that (nb, Q, 128*segments) candidate sheet.
// The three reduce paths of the reference are reproduced bit for bit: the
// packed int32 key score*rows + (rows-1-row) with its floor-division decode
// and sentinel, the packed_scaled total-order float key with the low row
// bits cleared, and the general max + smallest-row path.
//
// What bounds it on the H100: operations. At the main shape (1,048,576 x
// 768 int8 corpus, 8192 queries) the scan is 2*Q*N*d = 1.32e13 int8
// operations, 6.7 ms at the 1,979 TOP/s dense int8 tensor-core rate, while
// the corpus is read in 0.24 ms at 3.35 TB/s.
//
// What this design does about it: nothing fast yet — it is the simple,
// exact first kernel. It runs on the CUDA cores, not the tensor cores:
// __dp4a for int8 (4 MACs per instruction) and fmaf for bf16/f32 rows
// (upcast to f32 when staged). One 256-thread block owns one query tile of
// 64 queries and one segment of one corpus block; threads own lanes, each
// keeping the running (key, row) of 8 queries x 4 lanes in registers across
// the segment's row groups, so no score ever leaves registers. Query and
// corpus chunks of 64 bytes of depth are staged in shared memory with a
// 20-word row pitch, which makes the 16-byte shared loads of a warp's 32
// different corpus rows conflict-free. The query tile index varies fastest
// in the grid, so the blocks in flight share one or two corpus blocks and
// the corpus is read from device memory about once. wgmma/TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int QT = 64;        // queries per thread block
constexpr int TQ = 8;         // queries per thread: tq*TQ + i
constexpr int TL = 4;         // lanes per thread: tl + 32*j
constexpr int THREADS = 256;  // (QT / TQ) warps x 32 lane groups
constexpr int KW = 16;        // 32-bit shared words of depth per chunk
constexpr int PITCH = 20;     // shared row pitch in words
constexpr float NEG = -3.0e38f;
constexpr int INT_MIN32 = -2147483647 - 1;

enum Mode { PACKED = 0, PACKED_SCALED = 1, GENERAL = 2 };

// How a 32-bit shared word is filled from device memory: int8 rows pack
// four elements per word (dotted with __dp4a), float rows hold one f32.
template <typename T> struct Elem;
template <> struct Elem<int8_t> {
  static constexpr int PER_WORD = 4;
  __device__ static uint32_t load(const int8_t* p, long long i) {
    return *reinterpret_cast<const uint32_t*>(p + i);
  }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 1;
  __device__ static uint32_t load(const __nv_bfloat16* p, long long i) {
    return __float_as_uint(__bfloat162float(p[i]));
  }
};
template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static uint32_t load(const float* p, long long i) {
    return __float_as_uint(p[i]);
  }
};

template <bool INT8> struct Acc;
template <> struct Acc<true> {
  using T = int;
  __device__ static void mac(int& acc, uint32_t a, uint32_t b) {
    acc = __dp4a(static_cast<int>(a), static_cast<int>(b), acc);
  }
  __device__ static float to_float(int v) { return __int2float_rn(v); }
};
template <> struct Acc<false> {
  using T = float;
  __device__ static void mac(float& acc, uint32_t a, uint32_t b) {
    acc = fmaf(__uint_as_float(a), __uint_as_float(b), acc);
  }
  __device__ static float to_float(float v) { return v; }
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <typename C, typename Q, int MODE>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const C* __restrict__ corpus, long long ld,
            const Q* __restrict__ queries, int q_count, int d,
            const float* __restrict__ inv, const uint8_t* __restrict__ mask,
            long long valid_n, int block_rows, int nseg, int rows_total,
            int sentinel, int rmask, float* __restrict__ vals,
            int* __restrict__ ids) {
  constexpr bool INT8 = sizeof(C) == 1;
  using A = Acc<INT8>;
  using acc_t = typename A::T;
  constexpr int PER_WORD = Elem<C>::PER_WORD;
  static_assert(PER_WORD == Elem<Q>::PER_WORD, "query/corpus word mismatch");

  __shared__ __align__(16) uint32_t qs[QT * PITCH];
  __shared__ __align__(16) uint32_t cs[LANES * PITCH];

  const int tid = threadIdx.x;
  const int tl = tid & 31;
  const int tq = tid >> 5;
  const int q0 = blockIdx.x * QT;
  const int blk = blockIdx.y / nseg;
  const int seg = blockIdx.y % nseg;
  const long long seg_off = static_cast<long long>(seg) * rows_total * LANES;
  const long long seg_row0 =
      static_cast<long long>(blk) * block_rows + seg_off;
  const int words = d / PER_WORD;

  int bkey[TQ][TL];    // PACKED / PACKED_SCALED: running key max
  float bval[TQ][TL];  // GENERAL: running max
  int brow[TQ][TL];    // GENERAL: its row group
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      bkey[i][j] = INT_MIN32;
      bval[i][j] = __int_as_float(0xff800000);
      brow[i][j] = 0;
    }

  for (int r = 0; r < rows_total; ++r) {
    const long long row0 = seg_row0 + static_cast<long long>(r) * LANES;
    acc_t acc[TQ][TL];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TL; ++j) acc[i][j] = 0;

    for (int kw0 = 0; kw0 < words; kw0 += KW) {
      for (int w = tid; w < QT * KW; w += THREADS) {
        const int qi = w / KW, kw = w % KW, q = q0 + qi, kk = kw0 + kw;
        uint32_t v = 0;
        if (q < q_count && kk < words)
          v = Elem<Q>::load(queries, static_cast<long long>(q) * d +
                                         static_cast<long long>(kk) * PER_WORD);
        qs[qi * PITCH + kw] = v;
      }
      for (int w = tid; w < LANES * KW; w += THREADS) {
        const int li = w / KW, kw = w % KW, kk = kw0 + kw;
        uint32_t v = 0;
        if (kk < words)
          v = Elem<C>::load(corpus, (row0 + li) * ld +
                                        static_cast<long long>(kk) * PER_WORD);
        cs[li * PITCH + kw] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < KW; kw += 4) {
        uint4 b[TL];
#pragma unroll
        for (int j = 0; j < TL; ++j)
          b[j] = *reinterpret_cast<const uint4*>(&cs[(tl + 32 * j) * PITCH + kw]);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          const uint4 a =
              *reinterpret_cast<const uint4*>(&qs[(tq * TQ + i) * PITCH + kw]);
#pragma unroll
          for (int j = 0; j < TL; ++j) {
            A::mac(acc[i][j], a.x, b[j].x);
            A::mac(acc[i][j], a.y, b[j].y);
            A::mac(acc[i][j], a.z, b[j].z);
            A::mac(acc[i][j], a.w, b[j].w);
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
      const int tie = rows_total - 1 - r;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        if constexpr (MODE == PACKED) {
          const int sv = valid ? static_cast<int>(acc[i][j]) : sentinel;
          bkey[i][j] = max(bkey[i][j], sv * rows_total + tie);
        } else if constexpr (MODE == PACKED_SCALED) {
          const float f = __fmul_rn(A::to_float(acc[i][j]), scale);
          const int b = __float_as_int(f);
          int key = (b ^ ((b >> 31) & 0x7FFFFFFF)) & ~rmask;
          if (!valid) key = INT_MIN32;
          bkey[i][j] = max(bkey[i][j], key | (tie & rmask));
        } else {
          float v = A::to_float(acc[i][j]);
          if (inv != nullptr) v = __fmul_rn(v, scale);
          if (!valid) v = NEG;
          if (v > bval[i][j]) {
            bval[i][j] = v;
            brow[i][j] = r;
          }
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
      const int m = bkey[i][j];
      int local_row;
      float v;
      if constexpr (MODE == PACKED) {
        const int vq = floor_div(m, rows_total);
        local_row = (rows_total - 1) - (m - vq * rows_total);
        v = (vq <= sentinel) ? NEG : __int2float_rn(vq);
      } else if constexpr (MODE == PACKED_SCALED) {
        local_row = (rows_total - 1) - (m & rmask);
        const int keyc = m & ~rmask;
        const int b2 = keyc ^ ((keyc >> 31) & 0x7FFFFFFF);
        v = (m <= (INT_MIN32 | rmask)) ? NEG : __int_as_float(b2);
      } else {
        local_row = brow[i][j];
        v = bval[i][j];
      }
      vals[out + lane] = v;
      ids[out + lane] = static_cast<int>(
          static_cast<long long>(local_row) * LANES + lane + id_base);
    }
  }
}

template <typename C, typename Q, int MODE>
cudaError_t launch(const void* corpus, long long ld, const void* queries,
                   int q_count, int d, const float* inv, const uint8_t* mask,
                   long long valid_n, int nb, int block_rows, int nseg,
                   int rows_total, int sentinel, int rmask, float* vals,
                   int* ids, cudaStream_t stream) {
  const dim3 grid((q_count + QT - 1) / QT, nb * nseg);
  scan_kernel<C, Q, MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const C*>(corpus), ld, static_cast<const Q*>(queries),
      q_count, d, inv, mask, valid_n, block_rows, nseg, rows_total, sentinel,
      rmask, vals, ids);
  return cudaGetLastError();
}

}  // namespace

// corpus_dtype: 0 int8 (queries int8), 1 bf16 (queries f32), 2 f32 (queries
// f32). mode: 0 packed, 1 packed_scaled, 2 general. valid_n < 0: no bound.
// inv / mask may be null. Returns a cudaError_t (0 = launched).
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
  const int sentinel = -(d * 127 * 127 + 1);
  int row_bits = 1;
  while ((1 << row_bits) - 1 < rows_total - 1) ++row_bits;
  const int rmask = (1 << row_bits) - 1;
  auto s = static_cast<cudaStream_t>(stream);
#define SCAN_ARGS corpus, ld, queries, q_count, d, inv, mask, valid_n, nb, \
                  block_rows, nseg, rows_total, sentinel, rmask, vals, ids, s
  if (corpus_dtype == 0) {
    if (d % 4) return cudaErrorInvalidValue;
    if (mode == PACKED) return launch<int8_t, int8_t, PACKED>(SCAN_ARGS);
    if (mode == PACKED_SCALED) {
      if (inv == nullptr) return cudaErrorInvalidValue;
      return launch<int8_t, int8_t, PACKED_SCALED>(SCAN_ARGS);
    }
    if (mode == GENERAL) return launch<int8_t, int8_t, GENERAL>(SCAN_ARGS);
  } else if (mode == GENERAL) {
    if (corpus_dtype == 1)
      return launch<__nv_bfloat16, float, GENERAL>(SCAN_ARGS);
    if (corpus_dtype == 2) return launch<float, float, GENERAL>(SCAN_ARGS);
  }
#undef SCAN_ARGS
  return cudaErrorInvalidValue;
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
