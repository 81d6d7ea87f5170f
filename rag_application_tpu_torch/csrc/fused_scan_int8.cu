// Fused int8 similarity scan with lane-bin max reduce on Hopper's tensor
// cores (sm_90a): the int8 branch of fused_scan_launch (fused_scan.cu).
//
// Replaces: rag_application_tpu/ops/fused_topk.py::_scan_kernel (the Pallas
// TPU kernel launched by fused_scan_topk) on its int8 reduce paths; the
// bf16/f32 general path stays on fused_scan.cu's CUDA-core kernel. For every
// corpus block, segment and query, bin `lane` keeps the max over row groups r
// of score(query, row r*128 + lane), ties toward the smaller r, and only the
// (nb, Q, 128*segments) candidate sheet is written. The fold and decode are
// the reference's to the bit: the packed key score*rows + (rows-1-r) with its
// sentinel and floor-division decode, the packed_scaled total-order float key
// with the low row bits cleared, and the general max with the first row.
// int8 x int8 products summed in int32 are exact in any order (|score| <=
// d*127^2), so the sheet is bit-equal to scan_sheet_plain's.
//
// What bounds it on the H100: operations, 2*Q*N*d int8 ops. At the main
// shape (1,048,576 x 768 corpus, 8192 queries) that is 1.32e13, 6.67 ms at
// the 1,979 TOP/s dense int8 tensor-core rate, which is reckoned for wgmma;
// warp-level mma.sync, which this kernel issues, tops out below it on Hopper.
// The corpus itself is read from device memory in 0.24 ms.
//
// Design. A 256-thread block (8 warps: 2 over queries x 4 over lanes) owns a
// tile of 32*MT queries and one segment of one corpus block, i.e. all 128
// lanes of each of the segment's row groups. Each warp computes a 16*MT-query
// x 32-lane score tile with mma.sync.m16n8k32.row.col.s32.s8.s8.s32: query
// rows and corpus rows are both K-contiguous, which is the row.col layout, so
// nothing is transposed. Operands come from shared memory through ldmatrix;
// staged rows are KC = 256 bytes with their 16-byte units XOR-swizzled by the
// row's low 3 bits, so the 8 rows an ldmatrix phase reads at one unit fall in
// different banks. The accumulator fragment gives each thread fixed (query,
// lane) pairs, so the running key (or value and row) of each pair stays in
// registers across all row groups: after a row group's K loop the fold runs
// on the fragment (valid, mask and scale read per lane) and the accumulators
// are zeroed. The packed paths take 128 queries (64 accumulators + 64 keys a
// thread); the general path keeps a value and a row per pair, so it takes 64
// queries to stay clear of spills.
//
// The query tile is staged once per block and reused by every row group of
// the segment; corpus chunks of 128 rows x 256 bytes stream through a
// 3-stage cp.async.cg ring that runs on across row groups, so the next
// group's loads are in flight during the fold (256-byte chunks take half the
// barriers of 128-byte ones). Where the resident query tile and the ring
// exceed the 227 KB a block may use (d > 1024 at 128 queries, d > 2048 at
// 64), each ring stage carries the matching query chunk as well. Query rows
// past q_count and depth past d are zero-filled (cp.async with src-size 0)
// and add 0 to every dot; 16-byte copies are used where d, the row stride and
// both base pointers allow, 4-byte copies otherwise. The query tile index
// varies fastest in the grid, so the blocks in flight share one or two corpus
// blocks in L2 and the corpus is read from device memory about once; every
// query tile still streams it from L2 (51.5 GB at the main shape).
//
// kernels/scan_study.py measures the card's mma.sync peak and times copies
// of this kernel with the ring loads, the operand loads or the fold cut, to
// show what each part costs. Left for later: wgmma on 64-row warpgroup tiles
// from shared-memory descriptors, fed by TMA (multicast across a cluster, so
// query tiles share one L2 read of the corpus) with mbarriers and a producer
// warp, and a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;        // bins per segment = rows per row group
constexpr int KC = 256;           // bytes of depth per staged chunk
constexpr int UNITS = KC / 16;    // 16-byte units per staged row
constexpr int STAGES = 3;         // corpus ring depth
constexpr int THREADS = 256;      // 2 (queries) x 4 (lanes) warps
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr float NEG = -3.0e38f;
constexpr int INT_MIN32 = -2147483647 - 1;

enum Mode { PACKED = 0, PACKED_SCALED = 1, GENERAL = 2 };

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte unit u of row r in a staged tile
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return static_cast<uint32_t>(r * KC + ((u ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [0, ROWS) x depth [k0, k0 + KC) of a row-major int8 matrix
// (row stride ld) into the swizzled tile at dst. Rows >= live and depth >= d
// are zero-filled: cp.async with src-size 0 reads nothing.
template <int ROWS>
__device__ __forceinline__ void stage_tile(uint32_t dst, const int8_t* src,
                                           long long ld, int live, int k0,
                                           int d, bool vec16) {
  static_assert(ROWS * UNITS % THREADS == 0, "tile rows");
#pragma unroll
  for (int j = 0; j < ROWS * UNITS / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / UNITS, u = i % UNITS, k = k0 + u * 16;
    const bool row_ok = r < live;
    const int8_t* p = row_ok ? src + r * ld : src;
    const uint32_t s = dst + swz(r, u);
    if (vec16) {
      const bool ok = row_ok && k < d;
      cp_async16(s, ok ? p + k : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const bool ok = row_ok && k + 4 * w < d;
        cp_async4(s + 4 * w, ok ? p + k + 4 * w : src, ok ? 4 : 0);
      }
    }
  }
}

// MT: m-tiles of 16 queries per warp (block tile 32*MT queries).
// RESIDENT: the whole query tile is staged once; otherwise every ring stage
// carries its query chunk beside the corpus chunk.
template <int MODE, int MT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
scan_int8_kernel(const int8_t* __restrict__ corpus, long long ld,
                 const int8_t* __restrict__ queries, int q_count, int d,
                 const float* __restrict__ inv,
                 const uint8_t* __restrict__ mask, long long valid_n,
                 int block_rows, int nseg, int rows_total, int sentinel,
                 int rmask, bool vec16, float* __restrict__ vals,
                 int* __restrict__ ids) {
  constexpr int QT = 2 * MT * 16;
  constexpr int C_BYTES = LANES * KC;
  constexpr int Q_BYTES = QT * KC;
  constexpr int STAGE = C_BYTES + (RESIDENT ? 0 : Q_BYTES);
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lid = tid & 31, warp = tid >> 5;
  const int wq = warp >> 2, wl = warp & 3;  // query half, lane quarter
  const int g = lid >> 2, tig = lid & 3;    // fragment row, column pair
  const int q0 = blockIdx.x * QT;
  const int blk = blockIdx.y / nseg;
  const int seg = blockIdx.y % nseg;
  const long long seg_off = static_cast<long long>(seg) * rows_total * LANES;
  const long long seg_row0 =
      static_cast<long long>(blk) * block_rows + seg_off;
  const int8_t* qsrc = queries + static_cast<long long>(q0) * d;
  const int q_live = q_count - q0;
  const int nkc = (d + KC - 1) / KC;
  const int total = rows_total * nkc;
  const uint32_t qs = smem_addr(smem);
  const uint32_t ring = qs + (RESIDENT ? nkc * Q_BYTES : 0);

  // ring load of row group r, depth chunk kc, into stage st
  auto load = [&](int r, int kc, int st) {
    const uint32_t base = ring + st * STAGE;
    stage_tile<LANES>(
        base, corpus + (seg_row0 + static_cast<long long>(r) * LANES) * ld,
        ld, LANES, kc * KC, d, vec16);
    if constexpr (!RESIDENT)
      stage_tile<QT>(base + C_BYTES, qsrc, d, q_live, kc * KC, d, vec16);
  };
  if constexpr (RESIDENT)
    for (int kc = 0; kc < nkc; ++kc)
      stage_tile<QT>(qs + kc * Q_BYTES, qsrc, d, q_live, kc * KC, d, vec16);
  int lr = 0, lkc = 0;  // next ring load
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (lr < rows_total) {
      load(lr, lkc, st);
      if (++lkc == nkc) lkc = 0, ++lr;
    }
    cp_commit();
  }

  // fragment [mt][nt][i]: query wq*16*MT + 16*mt + g + 8*(i >> 1),
  // lane wl*32 + 8*nt + 2*tig + (i & 1)
  int acc[MT][4][4];
  int key[MT][4][4];     // PACKED / PACKED_SCALED: running key max
  float bval[MT][4][4];  // GENERAL: running max
  int brow[MT][4][4];    // GENERAL: its row group
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0;
        key[mt][nt][i] = INT_MIN32;
        bval[mt][nt][i] = __int_as_float(0xff800000);
        brow[mt][nt][i] = 0;
      }

  // ldmatrix rows: B (corpus) x4 = two n-tiles x two 16-byte units;
  // A (queries) x4 = rows 0-15 x two units
  const int b_row = wl * 32 + (lid & 7) + ((lid >> 4) << 3);
  const int b_hi = (lid >> 3) & 1;
  const int a_row = wq * MT * 16 + (lid & 15);
  const int a_hi = lid >> 4;

  int r = 0, kc = 0;
  for (int t = 0; t < total; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // chunk t landed; stage (t - 1) % STAGES is free
    if (lr < rows_total) {
      load(lr, lkc, (t + STAGES - 1) % STAGES);
      if (++lkc == nkc) lkc = 0, ++lr;
    }
    cp_commit();

    const uint32_t cb = ring + (t % STAGES) * STAGE;
    const uint32_t qb = RESIDENT ? qs + kc * Q_BYTES : cb + C_BYTES;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                    b[2 * np + 1][1], cb + swz(b_row + 16 * np, 2 * ks + b_hi));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a[0], a[1], a[2], a[3],
                    qb + swz(a_row + 16 * mt, 2 * ks + a_hi));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
    if (++kc < nkc) continue;

    // fold row group r into the running bin state
    const long long row0 = seg_row0 + static_cast<long long>(r) * LANES;
    uint32_t vbits = 0;  // per lane (nt, h): valid, and its scale
    float scale[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + wl * 32 + nt * 8 + 2 * tig + h;
        const bool ok = (valid_n < 0 || row < valid_n) &&
                        (mask == nullptr || mask[row] != 0);
        vbits |= static_cast<uint32_t>(ok) << (nt * 2 + h);
        scale[nt][h] = (inv != nullptr) ? inv[row] : 1.0f;
      }
    const int tie = rows_total - 1 - r;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i & 1;
          const bool valid = (vbits >> (nt * 2 + h)) & 1;
          const int s = acc[mt][nt][i];
          if constexpr (MODE == PACKED) {
            const int sv = valid ? s : sentinel;
            key[mt][nt][i] = max(key[mt][nt][i], sv * rows_total + tie);
          } else if constexpr (MODE == PACKED_SCALED) {
            const float f = __fmul_rn(__int2float_rn(s), scale[nt][h]);
            const int bits = __float_as_int(f);
            int k = (bits ^ ((bits >> 31) & 0x7FFFFFFF)) & ~rmask;
            if (!valid) k = INT_MIN32;
            key[mt][nt][i] = max(key[mt][nt][i], k | (tie & rmask));
          } else {
            float v = __int2float_rn(s);
            if (inv != nullptr) v = __fmul_rn(v, scale[nt][h]);
            if (!valid) v = NEG;
            if (v > bval[mt][nt][i]) {
              bval[mt][nt][i] = v;
              brow[mt][nt][i] = r;
            }
          }
          acc[mt][nt][i] = 0;
        }
    kc = 0;
    ++r;
  }
  cp_wait<0>();

  const long long id_base = seg_off + static_cast<long long>(blk) * block_rows;
  const int bins_out = nseg * LANES;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = q0 + wq * MT * 16 + mt * 16 + g + 8 * half;
      if (q >= q_count) continue;
      const long long out =
          (static_cast<long long>(blk) * q_count + q) * bins_out + seg * LANES;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int lane0 = wl * 32 + nt * 8 + 2 * tig;
        float v[2];
        int id[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 2 * half + h;
          const int m = key[mt][nt][i];
          int local_row;
          if constexpr (MODE == PACKED) {
            const int vq = floor_div(m, rows_total);
            local_row = (rows_total - 1) - (m - vq * rows_total);
            v[h] = (vq <= sentinel) ? NEG : __int2float_rn(vq);
          } else if constexpr (MODE == PACKED_SCALED) {
            local_row = (rows_total - 1) - (m & rmask);
            const int keyc = m & ~rmask;
            const int b2 = keyc ^ ((keyc >> 31) & 0x7FFFFFFF);
            v[h] = (m <= (INT_MIN32 | rmask)) ? NEG : __int_as_float(b2);
          } else {
            local_row = brow[mt][nt][i];
            v[h] = bval[mt][nt][i];
          }
          id[h] = static_cast<int>(static_cast<long long>(local_row) * LANES +
                                   lane0 + h + id_base);
        }
        *reinterpret_cast<float2*>(vals + out + lane0) = make_float2(v[0], v[1]);
        *reinterpret_cast<int2*>(ids + out + lane0) = make_int2(id[0], id[1]);
      }
    }
}

template <int MODE, int MT, bool RESIDENT>
cudaError_t launch_tile(const int8_t* corpus, long long ld,
                        const int8_t* queries, int q_count, int d,
                        const float* inv, const uint8_t* mask,
                        long long valid_n, int nb, int block_rows, int nseg,
                        int rows_total, int sentinel, int rmask, bool vec16,
                        float* vals, int* ids, size_t smem,
                        cudaStream_t stream) {
  auto kernel = scan_int8_kernel<MODE, MT, RESIDENT>;
  // above 48 KB of dynamic shared memory needs an opt-in (a host-side
  // attribute of the function, cheap to set on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  constexpr int QT = 2 * MT * 16;
  const dim3 grid((q_count + QT - 1) / QT, nb * nseg);
  kernel<<<grid, THREADS, smem, stream>>>(
      corpus, ld, queries, q_count, d, inv, mask, valid_n, block_rows, nseg,
      rows_total, sentinel, rmask, vec16, vals, ids);
  return cudaGetLastError();
}

template <int MODE, int MT>
cudaError_t launch_mode(const int8_t* corpus, long long ld,
                        const int8_t* queries, int q_count, int d,
                        const float* inv, const uint8_t* mask,
                        long long valid_n, int nb, int block_rows, int nseg,
                        int rows_total, int sentinel, int rmask, bool vec16,
                        float* vals, int* ids, cudaStream_t stream) {
  constexpr size_t QT = 2 * MT * 16;
  const size_t nkc = (d + KC - 1) / KC;
  const size_t resident = nkc * QT * KC + size_t{STAGES} * LANES * KC;
#define TILE_ARGS corpus, ld, queries, q_count, d, inv, mask, valid_n, nb, \
                  block_rows, nseg, rows_total, sentinel, rmask, vec16,    \
                  vals, ids
  if (resident <= SMEM_MAX)
    return launch_tile<MODE, MT, true>(TILE_ARGS, resident, stream);
  return launch_tile<MODE, MT, false>(TILE_ARGS,
                                      size_t{STAGES} * (LANES + QT) * KC,
                                      stream);
#undef TILE_ARGS
}

}  // namespace

// The int8 branch of fused_scan_launch (fused_scan.cu), which checks the
// arguments and derives rows_total, sentinel and rmask.
cudaError_t fused_scan_int8(const void* corpus, long long ld,
                            const void* queries, int q_count, int d,
                            const float* inv, const uint8_t* mask,
                            long long valid_n, int nb, int block_rows,
                            int nseg, int mode, int rows_total, int sentinel,
                            int rmask, float* vals, int* ids,
                            cudaStream_t stream) {
  const auto c = static_cast<const int8_t*>(corpus);
  const auto q = static_cast<const int8_t*>(queries);
  const bool vec16 = d % 16 == 0 && ld % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
#define MODE_ARGS c, ld, q, q_count, d, inv, mask, valid_n, nb, block_rows, \
                  nseg, rows_total, sentinel, rmask, vec16, vals, ids, stream
  if (mode == PACKED) return launch_mode<PACKED, 4>(MODE_ARGS);
  if (mode == PACKED_SCALED) return launch_mode<PACKED_SCALED, 4>(MODE_ARGS);
  if (mode == GENERAL) return launch_mode<GENERAL, 2>(MODE_ARGS);
#undef MODE_ARGS
  return cudaErrorInvalidValue;
}
