// Fused bf16 similarity scan with lane-bin max reduce on Hopper's tensor
// cores (sm_90a): the bf16-corpus, bf16-query branch of fused_scan_launch
// (fused_scan.cu).
//
// Replaces: rag_application_tpu/ops/fused_topk.py::_scan_kernel (the Pallas
// TPU kernel launched by fused_scan_topk) on its general reduce path over a
// bf16 corpus, which the matryoshka cascade's prefix scan takes. For every
// corpus block, segment and query, bin `lane` keeps the max over row groups r
// of dot(query, row r*128 + lane) * inv[row], invalid rows scoring NEG, ties
// toward the smaller r, and only the (nb, Q, 128*segments) candidate sheet of
// f32 values and int32 row ids is written. A bf16 x bf16 product is exact in
// f32, so the kernel computes the products of scan_sheet_plain and differs
// from it only in the order of the f32 sums (|error| <= d * 2^-24 a side for
// unit rows).
//
// What bounds it on the H100: operations, 2*Q*N*d bf16 flops. The cascade's
// prefix-128 scan (1,048,576 rows, 8192 queries) is 2.2e12, 2.22 ms at the
// 989 TFLOP/s dense bf16 tensor-core rate, which is reckoned for wgmma;
// warp-level mma.sync, which this kernel issues, tops out below it. The 268 MB
// prefix is read from device memory in 0.08 ms.
//
// Design: fused_scan_int8.cu's, with 2-byte elements. A 256-thread block (8
// warps: 2 over queries x 4 over lanes) owns a tile of 32*MT queries and one
// segment of one corpus block. Each warp computes a 16*MT-query x 32-lane
// score tile with mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: query rows and
// corpus rows are both K-contiguous, the row.col layout, so nothing is
// transposed. Staged rows are KC = 256 bytes (128 elements, 8 k-steps) with
// their 16-byte units XOR-swizzled by the row's low 3 bits; ldmatrix.x4 reads
// the 16 x 16 A fragment or two n-tiles' B fragments without bank conflicts.
// The accumulator fragment gives each thread fixed (query, lane) pairs, so the
// running max of each pair stays in a register across all row groups: after a
// row group's K loop the fold runs on the fragment: scale, NEG where the row
// is invalid (skipped for a row group that no mask or valid_n touches), strict
// > so the first row group wins a tie.
//
// Corpus chunks of 128 rows x 256 bytes, with a row group's 128 scales behind
// its last chunk, stream through a 3-stage cp.async.cg ring that runs on
// across row groups, so the next group's loads are in flight during the fold;
// each thread copies the same unit of 8 rows of every chunk, so its addresses
// advance by a constant. Measured on the card, the products, the fold, the
// ring's copies and the operand reads do not overlap: their times add. So the
// query tile is as large as registers allow, which spreads each chunk's copy
// and barrier over more products:
//   * d <= 128 (one chunk a row group: the cascade's prefix scans), 128
//     queries (MT = 4): accumulator + value fill the registers, so the
//     winning row groups live in shared memory behind the ring, one column a
//     thread, written only when a pair's max rises; the query tile is staged
//     once and its A fragments are read at every k-step;
//   * d <= 128 where 128-query tiles would leave SMs without a block, 64
//     queries (MT = 2), and 32 (MT = 1) where 64 would too (the tokens wire:
//     256 queries over 16 corpus blocks): value and row group in registers,
//     and the block's A fragments too, read from shared memory once;
//   * deeper rows, 64 or 32 queries: the query tile staged once, or, where it
//     and the ring exceed the 227 KB a block may use (d > 1024 at 64
//     queries), each ring stage carries the matching query chunk as well.
// Where a row group is one chunk its first product takes a zero accumulator,
// so the fold clears nothing.
//
// Query rows past q_count and depth past d are zero-filled (cp.async with
// src-size 0) and add 0 to every dot; 16-byte copies are used where the row
// bytes, the row stride and both base pointers allow, 4-byte copies otherwise.
// cp.async copies no less than 4 bytes: an odd d or row stride, or a base
// pointer off a 4-byte boundary, is refused here and served by fused_scan.cu.
// The query tile index varies fastest in the grid, so the blocks in flight
// share one or two corpus blocks in L2; every query tile still streams the
// corpus from L2 (17 GB at the main shape with 128-query tiles).
//
// kernels/scan_study.py measures the card's bf16 mma.sync peak and times
// copies of this kernel with the fold, the ring loads or the operand reads
// cut, and with smaller tiles. Left for later: wgmma on 64-row warpgroup
// tiles fed by TMA (multicast across a cluster), a fold that runs beside the
// next row group's products, and a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;        // bins per segment = rows per row group
constexpr int KC = 256;           // bytes of depth per staged chunk
constexpr int UNITS = KC / 16;    // 16-byte units per staged row
constexpr int STAGES = 3;         // corpus ring depth
constexpr int THREADS = 256;      // 2 (queries) x 4 (lanes) warps
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int SCALE_BYTES = LANES * 4;  // a row group's scales in a stage
constexpr float NEG = -3.0e38f;

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

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16 x 16, row) * b (16 x 8, col): a row group's first product
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// Stage rows [0, ROWS) x row bytes [k0, k0 + KC) of a row-major matrix (row
// stride ld bytes, d bytes of depth a row) into the swizzled tile at dst.
// Rows >= live and bytes >= d are zero-filled: cp.async with src-size 0 reads
// nothing.
template <int ROWS>
__device__ __forceinline__ void stage_tile(uint32_t dst, const uint8_t* src,
                                           long long ld, int live, int k0,
                                           int d, bool vec16) {
  static_assert(ROWS * UNITS % THREADS == 0, "tile rows");
#pragma unroll
  for (int j = 0; j < ROWS * UNITS / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / UNITS, u = i % UNITS, k = k0 + u * 16;
    const bool row_ok = r < live;
    const uint8_t* p = row_ok ? src + r * ld : src;
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

// Fold one row group's scores into the running (max, row group) of each
// (query, lane) pair: scale, NEG where the row is invalid, strict > so the
// first row group wins a tie. CHECKED: some row may be invalid (vbits holds a
// bit per lane (nt, h)). The row groups are kept in brow (RT == MT) or, where
// registers do not hold them, in this thread's column of srow.
template <int MT, int RT, bool CHECKED, bool CLEAR>
__device__ __forceinline__ void fold_group(float (&acc)[MT][4][4],
                                           float (&bval)[MT][4][4],
                                           int (&brow)[RT][4][4], int* srow,
                                           int r, const float* scale,
                                           uint32_t vbits) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float sc[2] = {1.0f, 1.0f};
    if (scale != nullptr) {
      const float2 s2 = *reinterpret_cast<const float2*>(scale + nt * 8);
      sc[0] = s2.x, sc[1] = s2.y;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1;
        float v = acc[mt][nt][i];
        if (scale != nullptr) v = __fmul_rn(v, sc[h]);
        if (CHECKED && !((vbits >> (nt * 2 + h)) & 1)) v = NEG;
        if (v > bval[mt][nt][i]) {
          bval[mt][nt][i] = v;
          if constexpr (RT == MT)
            brow[mt][nt][i] = r;
          else
            srow[((mt * 4 + nt) * 4 + i) * THREADS] = r;
        }
        if (CLEAR) acc[mt][nt][i] = 0.0f;
      }
  }
}

// where a block's query tile lives while it scans
enum QueryHome {
  Q_REGS = 0,  // d <= 128: the A fragments stay in registers
  Q_SMEM = 1,  // the whole tile is staged once
  Q_RING = 2,  // every ring stage carries its query chunk
};

// corpus, queries: bf16 rows addressed in bytes (ld: corpus row stride in
// bytes, d: bytes of depth a row = the query row stride).
// MT: m-tiles of 16 queries per warp (block tile 32*MT queries).
template <int MT, int QH>
__global__ void __launch_bounds__(THREADS, 1)
scan_bf16_kernel(const uint8_t* __restrict__ corpus, long long ld,
                 const uint8_t* __restrict__ queries, int q_count, int d,
                 const float* __restrict__ inv,
                 const uint8_t* __restrict__ mask, long long valid_n,
                 int block_rows, int nseg, int rows_total, bool vec16,
                 float* __restrict__ vals, int* __restrict__ ids) {
  constexpr int QT = 2 * MT * 16;
  constexpr int C_BYTES = LANES * KC;
  constexpr int Q_BYTES = QT * KC;
  constexpr int S_OFF = C_BYTES + (QH == Q_RING ? Q_BYTES : 0);
  constexpr int STAGE = S_OFF + SCALE_BYTES;
  // one chunk a row group (the launcher's promise for Q_REGS and MT = 4):
  // a row group's first product has no accumulator to add
  constexpr bool ONE_CHUNK = QH == Q_REGS || MT == 4;
  // 128 queries: value + accumulator fill the registers, the row groups go to
  // shared memory behind the ring, one column of 16*MT words a thread
  constexpr int RT = MT == 4 ? 1 : MT;
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
  const uint8_t* qsrc = queries + static_cast<long long>(q0) * d;
  const int q_live = q_count - q0;
  const int nkc = (d + KC - 1) / KC;
  const int total = rows_total * nkc;
  const int ring_off = QH == Q_RING ? 0 : nkc * Q_BYTES;
  const uint32_t qs = smem_addr(smem);
  const uint32_t ring = qs + ring_off;

  // this thread's share of every corpus chunk: unit cu of rows cr + 16*j
  const int cr = tid / UNITS, cu = tid % UNITS;
  const uint8_t* csrc = corpus + (seg_row0 + cr) * ld + cu * 16;
  const uint32_t cdst = swz(cr, cu);  // rows 16 apart share the swizzle
  const long long ld16 = 16 * ld;

  // ring load of row group r, depth chunk kc, into stage st: the corpus
  // chunk, the query chunk where the tile is not resident, and with a row
  // group's last chunk its 128 scales
  auto load = [&](int r, int kc, int st) {
    const uint32_t base = ring + st * STAGE;
    const uint8_t* p = csrc + static_cast<long long>(r) * LANES * ld + kc * KC;
    const int k = kc * KC + cu * 16;
#pragma unroll
    for (int j = 0; j < LANES / 16; ++j) {
      const uint32_t s = base + cdst + j * 16 * KC;
      if (vec16) {
        const bool ok = k < d;
        cp_async16(s, ok ? p + j * ld16 : corpus, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const bool ok = k + 4 * w < d;
          cp_async4(s + 4 * w, ok ? p + j * ld16 + 4 * w : corpus, ok ? 4 : 0);
        }
      }
    }
    if constexpr (QH == Q_RING)
      stage_tile<QT>(base + C_BYTES, qsrc, d, q_live, kc * KC, d, vec16);
    if (inv != nullptr && kc == nkc - 1 && tid < LANES)
      cp_async4(base + S_OFF + 4 * tid,
                inv + seg_row0 + static_cast<long long>(r) * LANES + tid, 4);
  };
  if constexpr (QH != Q_RING)
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
  float acc[MT][4][4];
  float bval[MT][4][4];  // running max
  int brow[RT][4][4];    // its row group
  int* srow = reinterpret_cast<int*>(smem + ring_off + STAGES * STAGE) + tid;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0.0f;
        bval[mt][nt][i] = __int_as_float(0xff800000);
        if constexpr (RT == MT)
          brow[mt][nt][i] = 0;
        else
          srow[((mt * 4 + nt) * 4 + i) * THREADS] = 0;
      }

  // ldmatrix rows: B (corpus) x4 = two n-tiles x two 16-byte units;
  // A (queries) x4 = rows 0-15 x two units
  const int b_row = wl * 32 + (lid & 7) + ((lid >> 4) << 3);
  const int b_hi = (lid >> 3) & 1;
  const int a_row = wq * MT * 16 + (lid & 15);
  const int a_hi = lid >> 4;

  constexpr bool REGS = QH == Q_REGS;
  uint32_t areg[REGS ? MT : 1][REGS ? KC / 32 : 1][4];
  if constexpr (REGS) {
    cp_wait<STAGES - 2>();  // the first group holds the query tile
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks)
        ldmatrix_x4(areg[mt][ks][0], areg[mt][ks][1], areg[mt][ks][2],
                    areg[mt][ks][3], qs + swz(a_row + 16 * mt, 2 * ks + a_hi));
  }

  int r = 0, kc = 0;
  for (int t = 0; t < total; ++t) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // chunk t landed; stage (t - 1) % STAGES is free
    if (lr < rows_total) {
      load(lr, lkc, (t + STAGES - 1) % STAGES);
      if (++lkc == nkc) lkc = 0, ++lr;
    }
    cp_commit();

    const int st_off = ring_off + (t % STAGES) * STAGE;
    const uint32_t cb = qs + st_off;
    const uint32_t qb = QH == Q_RING ? cb + C_BYTES : qs + kc * Q_BYTES;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                    b[2 * np + 1][1], cb + swz(b_row + 16 * np, 2 * ks + b_hi));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (REGS) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (ks == 0)
              mma_bf16_first(acc[mt][nt], areg[mt][ks], b[nt][0], b[nt][1]);
            else
              mma_bf16(acc[mt][nt], areg[mt][ks], b[nt][0], b[nt][1]);
        } else {
          uint32_t a[4];
          ldmatrix_x4(a[0], a[1], a[2], a[3],
                      qb + swz(a_row + 16 * mt, 2 * ks + a_hi));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            if (ONE_CHUNK && ks == 0)
              mma_bf16_first(acc[mt][nt], a, b[nt][0], b[nt][1]);
            else
              mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        }
      }
    }
    if (++kc < nkc) continue;

    // fold row group r into the running bin state
    const long long row0 = seg_row0 + static_cast<long long>(r) * LANES;
    const float* scale =
        inv == nullptr ? nullptr
                       : reinterpret_cast<const float*>(smem + st_off + S_OFF) +
                             wl * 32 + 2 * tig;
    if (mask == nullptr && (valid_n < 0 || row0 + LANES <= valid_n)) {
      fold_group<MT, RT, false, !ONE_CHUNK>(acc, bval, brow, srow, r, scale, 0);
    } else {
      uint32_t vbits = 0;  // per lane (nt, h): the row is valid
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + wl * 32 + nt * 8 + 2 * tig + h;
          const bool ok = (valid_n < 0 || row < valid_n) &&
                          (mask == nullptr || mask[row] != 0);
          vbits |= static_cast<uint32_t>(ok) << (nt * 2 + h);
        }
      fold_group<MT, RT, true, !ONE_CHUNK>(acc, bval, brow, srow, r, scale, vbits);
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
          v[h] = bval[mt][nt][i];
          int row;
          if constexpr (RT == MT)
            row = brow[mt][nt][i];
          else
            row = srow[((mt * 4 + nt) * 4 + i) * THREADS];
          id[h] = static_cast<int>(static_cast<long long>(row) * LANES +
                                   lane0 + h + id_base);
        }
        *reinterpret_cast<float2*>(vals + out + lane0) = make_float2(v[0], v[1]);
        *reinterpret_cast<int2*>(ids + out + lane0) = make_int2(id[0], id[1]);
      }
    }
}

template <int MT, int QH>
cudaError_t launch_tile(const uint8_t* corpus, long long ld,
                        const uint8_t* queries, int q_count, int d,
                        const float* inv, const uint8_t* mask,
                        long long valid_n, int nb, int block_rows, int nseg,
                        int rows_total, bool vec16, float* vals, int* ids,
                        size_t smem, cudaStream_t stream) {
  auto kernel = scan_bf16_kernel<MT, QH>;
  // above 48 KB of dynamic shared memory needs an opt-in (a host-side
  // attribute of the function, cheap to set on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  constexpr int QT = 2 * MT * 16;
  const dim3 grid((q_count + QT - 1) / QT, nb * nseg);
  kernel<<<grid, THREADS, smem, stream>>>(corpus, ld, queries, q_count, d, inv,
                                          mask, valid_n, block_rows, nseg,
                                          rows_total, vec16, vals, ids);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mt(const uint8_t* corpus, long long ld,
                      const uint8_t* queries, int q_count, int d,
                      const float* inv, const uint8_t* mask, long long valid_n,
                      int nb, int block_rows, int nseg, int rows_total,
                      bool vec16, float* vals, int* ids,
                      cudaStream_t stream) {
  constexpr size_t QT = 2 * MT * 16;
  const size_t nkc = (d + KC - 1) / KC;
  const size_t stage = LANES * KC + SCALE_BYTES;
  const size_t resident = nkc * QT * KC + STAGES * stage;
#define TILE_ARGS corpus, ld, queries, q_count, d, inv, mask, valid_n, nb, \
                  block_rows, nseg, rows_total, vec16, vals, ids
  if constexpr (MT == 4) {  // d <= 128: the row groups live behind the ring
    return launch_tile<MT, Q_SMEM>(
        TILE_ARGS, resident + 16 * MT * THREADS * sizeof(int), stream);
  } else {
    if (nkc == 1) return launch_tile<MT, Q_REGS>(TILE_ARGS, resident, stream);
    if (resident <= SMEM_MAX)
      return launch_tile<MT, Q_SMEM>(TILE_ARGS, resident, stream);
    return launch_tile<MT, Q_RING>(TILE_ARGS, STAGES * (stage + QT * KC),
                                   stream);
  }
#undef TILE_ARGS
}

}  // namespace

// The bf16-corpus, bf16-query branch of fused_scan_launch (fused_scan.cu),
// which checks the grid arguments and derives rows_total. ld and d count
// elements here.
cudaError_t fused_scan_bf16(const void* corpus, long long ld,
                            const void* queries, int q_count, int d,
                            const float* inv, const uint8_t* mask,
                            long long valid_n, int nb, int block_rows,
                            int nseg, int rows_total, float* vals, int* ids,
                            cudaStream_t stream) {
  const auto c = static_cast<const uint8_t*>(corpus);
  const auto q = static_cast<const uint8_t*>(queries);
  const auto cp = reinterpret_cast<uintptr_t>(c);
  const auto qp = reinterpret_cast<uintptr_t>(q);
  if (d <= 0 || d % 2 || ld % 2 || cp % 4 || qp % 4)
    return cudaErrorInvalidValue;  // cp.async copies 4 bytes or 16
  const long long ldb = 2 * ld;
  const int db = 2 * d;
  const bool vec16 = db % 16 == 0 && ldb % 16 == 0 && cp % 16 == 0 &&
                     qp % 16 == 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
#define MT_ARGS c, ldb, q, q_count, db, inv, mask, valid_n, nb, block_rows, \
                nseg, rows_total, vec16, vals, ids, stream
  // the largest query tile that leaves no SM without a block; 128 queries
  // where a row group is one chunk
  const long long segs = static_cast<long long>(nb) * nseg;
  if (db <= KC && (q_count + 127) / 128 * segs >= sms)
    return launch_mt<4>(MT_ARGS);
  if ((q_count + 63) / 64 * segs >= sms) return launch_mt<2>(MT_ARGS);
  return launch_mt<1>(MT_ARGS);
#undef MT_ARGS
}
