// Fused f32 similarity scan with lane-bin max reduce on Hopper's tensor cores
// (sm_90a), at f32 accuracy from split TF32 products: the f32 branch of
// fused_scan_launch (fused_scan.cu).
//
// Replaces: rag_application_tpu/ops/fused_topk.py::_scan_kernel (the Pallas
// TPU kernel launched by fused_scan_topk) on its general reduce path with f32
// operands: an f32 corpus, f32 queries on a bf16 corpus, and every bf16 scan
// that cp.async cannot align (an odd depth or row stride, a pointer off 4
// bytes), whose queries the wrapper widens to f32. For every corpus block,
// segment and query, bin `lane` keeps the max over row groups r of
// dot(query, row r*128 + lane) * inv[row], invalid rows scoring NEG, ties
// toward the smaller r, and only the (nb, Q, 128*segments) candidate sheet of
// f32 values and int32 row ids is written.
//
// The products. Hopper has no f32 tensor-core product, and one TF32 product
// (11-bit significands) is ~2^-11 off. Each f32 operand x is split into two
// TF32 values, big = rna(x) and small = rna(x - big), rounded to nearest with
// ties away as cvt.rna.tf32.f32 rounds, and a dot is big.big + big.small +
// small.big, the two small products added first; the dropped small.small and
// the roundings of small are at most 2^-21 of each |a_i b_i|, below f32's
// own rounding of the sum (d * 2^-24; ops/fused_topk.py::tf32_split_dot is
// the plain model). A bf16 corpus value is exact in TF32, so its products are
// two (big.c + small.c).
//
// What bounds it on the H100: operations. 2*Q*N*d flops, three (f32 corpus)
// or two (bf16 corpus) TF32 products each: 3.33 ms at 262,144 x 128 f32 with
// 8,192 queries and 8.89 ms over the cascade's 1,048,576 x 128 bf16 prefix,
// at the 495 TFLOP/s dense TF32 rate reckoned for wgmma; warp-level mma.sync,
// which this kernel issues, tops out near 318 TFLOP/s on the card
// (kernels/scan_study.py), a 5.2 ms floor at the first shape.
//
// Design: fused_scan_bf16.cu's. A 256-thread block (8 warps: 2 over queries x
// 4 over lanes) owns a tile of 32*MT queries and one segment of one corpus
// block; each warp computes a 16*MT-query x 32-lane score tile with
// mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32, whose accumulator fragment is
// the bf16 kernel's, so the running (max, row group) of each (query, lane)
// pair stays in registers and the fold is the same: scale, NEG where the row
// is invalid, strict > so the first row group wins a tie. Corpus chunks of 128
// rows x 256 bytes (64 f32 or 128 bf16 of depth), a row group's 128 scales
// behind its last chunk, stream through the 3-stage cp.async.cg ring with the
// 16-byte units of each row XOR-swizzled by its low 3 bits, and ldmatrix.x4
// reads two n-tiles of B fragments: a 32-bit element arrives as a pair of b16
// halves, which is the tf32 fragment's (row lane/4, element lane%4) layout.
// The corpus fragment is split in registers once a read (each element once
// per query tile); a bf16 fragment holds elements (2t, 2t+1) of 8, each
// widened by a shift or a mask, and those two meet the mma's k = t and t + 4.
//
// The query tile is split once, when it is staged with ordinary loads, into a
// big and a small tile in shared memory, in the same swizzled layout; over a
// bf16 corpus each group of 8 elements is stored in the order (0, 2, 4, 6, 1,
// 3, 5, 7) so that ldmatrix hands each thread the elements its corpus pair
// holds. Rows past q_count and depth past d are zero. The whole tile stays
// resident where it and the ring fit in the 227 KB a block may use; deeper
// rows carry the matching query chunk in every ring stage, staged (and split)
// when the stage is loaded. 64-query tiles where they leave no SM without a
// block, 32 otherwise or where 64 do not fit.
//
// Corpus copies: 16-byte cp.async where the row bytes, the row stride and the
// base pointer allow; 4-byte cp.async otherwise (any f32 row, a bf16 row of
// even depth and stride on a 4-byte boundary); ordinary 2-byte loads into the
// same layout for bf16 that cp.async cannot copy at all. Depth past d is
// zero-filled. The query tile index varies fastest in the grid, so the blocks
// in flight share one or two corpus blocks in L2.
//
// Left for later: 128-query tiles (at 64, ~165 registers and 161 KB of shared
// memory a block), wgmma on 64-row warpgroup tiles fed by TMA, and a fold
// that runs beside the next row group's products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;        // bins per segment = rows per row group
constexpr int KC = 256;           // bytes of corpus depth per staged chunk
constexpr int UNITS = KC / 16;    // 16-byte units per staged corpus row
constexpr int STAGES = 3;         // corpus ring depth
constexpr int THREADS = 256;      // 2 (queries) x 4 (lanes) warps
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr int SCALE_BYTES = LANES * 4;  // a row group's scales in a stage
constexpr float NEG = -3.0e38f;

// how a corpus chunk reaches shared memory
enum Copy { COPY16 = 0, COPY4 = 1, COPY_PLAIN = 2 };

// where a block's split query tile lives while it scans
enum QueryHome {
  Q_SMEM = 0,  // the whole tile is staged once
  Q_RING = 1,  // every ring stage carries its query chunk
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte unit u of row r in a staged tile of PITCH-byte rows
template <int PITCH>
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return static_cast<uint32_t>(r * PITCH + ((u ^ (r & 7)) << 4));
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the bits of x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to
// nearest, ties away from zero, on the low 13 bits. The f32 bit pattern is
// sign and magnitude, so half a TF32 ulp added to it rounds the magnitude.
// Two integer operations where cvt.rna takes four (it checks for inf and
// nan first); an inf or nan x yields inf or nan, and a dot that meets one
// is nan either way.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t x) {
  return (x + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ at most 2^-23 |x|), both TF32
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__float_as_uint(__uint_as_float(x) -
                                   __uint_as_float(big)));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage query rows [0, QT) x elements [e0, e0 + QKC / 4) of the f32 query
// tile (row stride d elements) into the split tiles at big and small (QT x
// QKC bytes each, swizzled), with ordinary loads. Rows >= live and elements
// >= d are zero. PERM (a bf16 corpus): each group of 8 elements is stored in
// the order (0, 2, 4, 6, 1, 3, 5, 7).
template <int QT, int QKC, bool PERM>
__device__ __forceinline__ void stage_query(uint8_t* big, uint8_t* small,
                                            const float* src, int d, int live,
                                            int e0) {
  constexpr int QE = QKC / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < QT * QE; i += THREADS) {
    const int r = i / QE, e = i % QE, k = e0 + e;
    const float x = r < live && k < d
                        ? src[static_cast<long long>(r) * d + k]
                        : 0.0f;
    uint32_t hb, hs;
    split_tf32(__float_as_uint(x), hb, hs);
    const int p = PERM ? (e & ~7) | ((e & 7) >> 1) | ((e & 1) << 2) : e;
    const uint32_t off = swz<QKC>(r, p >> 2) + (p & 3) * 4;
    *reinterpret_cast<uint32_t*>(big + off) = hb;
    *reinterpret_cast<uint32_t*>(small + off) = hs;
  }
}

// Fold one row group's scores into the running (max, row group) of each
// (query, lane) pair, clearing the accumulator: scale, NEG where the row is
// invalid, strict > so the first row group wins a tie. CHECKED: some row may
// be invalid (vbits holds a bit per lane (nt, h)).
template <int MT, bool CHECKED>
__device__ __forceinline__ void fold_group(float (&acc)[MT][4][4],
                                           float (&bval)[MT][4][4],
                                           int (&brow)[MT][4][4], int r,
                                           const float* scale,
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
          brow[mt][nt][i] = r;
        }
        acc[mt][nt][i] = 0.0f;
      }
  }
}

// corpus: f32 or (CBF16) bf16 rows addressed in bytes (ld: row stride in
// bytes, db: bytes of depth a row); queries: f32, d elements a row.
// MT: m-tiles of 16 queries per warp (block tile 32*MT queries).
template <int MT, int QH, bool CBF16>
__global__ void __launch_bounds__(THREADS, 1)
scan_tf32_kernel(const uint8_t* __restrict__ corpus, long long ld, int db,
                 const float* __restrict__ queries, int q_count, int d,
                 const float* __restrict__ inv,
                 const uint8_t* __restrict__ mask, long long valid_n,
                 int block_rows, int nseg, int rows_total, int copy,
                 float* __restrict__ vals, int* __restrict__ ids) {
  constexpr int QT = 2 * MT * 16;
  constexpr int QKC = CBF16 ? 2 * KC : KC;  // query bytes per corpus chunk
  constexpr int QTILE = QT * QKC;           // one split half of a chunk
  constexpr int C_BYTES = LANES * KC;
  constexpr int S_OFF = C_BYTES + (QH == Q_RING ? 2 * QTILE : 0);
  constexpr int STAGE = S_OFF + SCALE_BYTES;
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
  const float* qsrc = queries + static_cast<long long>(q0) * d;
  const int q_live = q_count - q0;
  const int nkc = (db + KC - 1) / KC;
  const int total = rows_total * nkc;
  const int ring_off = QH == Q_RING ? 0 : nkc * 2 * QTILE;
  const uint32_t sbase = smem_addr(smem);
  const uint32_t ring = sbase + ring_off;

  // this thread's share of every corpus chunk: unit cu of rows cr + 16*j
  const int cr = tid / UNITS, cu = tid % UNITS;
  const uint8_t* csrc = corpus + (seg_row0 + cr) * ld + cu * 16;
  const uint32_t cdst = swz<KC>(cr, cu);  // rows 16 apart share the swizzle
  const long long ld16 = 16 * ld;

  // ring load of row group r, depth chunk kc, into stage st: the corpus
  // chunk, the split query chunk where the tile is not resident, and with a
  // row group's last chunk its 128 scales
  auto load = [&](int r, int kc, int st) {
    const uint32_t base = ring + st * STAGE;
    const uint8_t* p = csrc + static_cast<long long>(r) * LANES * ld + kc * KC;
    const int k = kc * KC + cu * 16;
#pragma unroll
    for (int j = 0; j < LANES / 16; ++j) {
      const uint32_t s = base + cdst + j * 16 * KC;
      const uint8_t* pj = p + j * ld16;
      if (copy == COPY16) {
        const bool ok = k < db;
        cp_async16(s, ok ? pj : corpus, ok ? 16 : 0);
      } else if (copy == COPY4) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const bool ok = k + 4 * w < db;
          cp_async4(s + 4 * w, ok ? pj + 4 * w : corpus, ok ? 4 : 0);
        }
      } else {  // bf16 at any alignment: 2-byte loads
        const uint16_t* e = reinterpret_cast<const uint16_t*>(pj);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t lo = k + 4 * i < db ? e[2 * i] : 0u;
          const uint32_t hi = k + 4 * i + 2 < db ? e[2 * i + 1] : 0u;
          w[i] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(smem + (s - sbase)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    if constexpr (QH == Q_RING) {
      uint8_t* qt = smem + (base - sbase) + C_BYTES;
      stage_query<QT, QKC, CBF16>(qt, qt + QTILE, qsrc, d, q_live,
                                  kc * (QKC / 4));
    }
    if (inv != nullptr && kc == nkc - 1 && tid < LANES)
      cp_async4(base + S_OFF + 4 * tid,
                inv + seg_row0 + static_cast<long long>(r) * LANES + tid, 4);
  };
  if constexpr (QH == Q_SMEM)
    for (int kc = 0; kc < nkc; ++kc)
      stage_query<QT, QKC, CBF16>(smem + kc * 2 * QTILE,
                                  smem + kc * 2 * QTILE + QTILE, qsrc, d,
                                  q_live, kc * (QKC / 4));
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
  int brow[MT][4][4];    // its row group
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] = 0.0f;
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

    const int st_off = ring_off + (t % STAGES) * STAGE;
    const uint32_t cb = sbase + st_off;
    const uint32_t qb =
        QH == Q_RING ? cb + C_BYTES : sbase + kc * 2 * QTILE;  // big half
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t x[4];
        ldmatrix_x4(x, cb + swz<KC>(b_row + 16 * np, 2 * ks + b_hi));
        b[2 * np][0] = x[0], b[2 * np][1] = x[1];
        b[2 * np + 1][0] = x[2], b[2 * np + 1][1] = x[3];
      }
      if constexpr (!CBF16) {
        // 8 elements of depth: B (k = tig, tig + 4) split in registers
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_tf32(b[nt][h], bb[nt][h], bs[nt][h]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t ab[4], as[4];
          const uint32_t a = swz<QKC>(a_row + 16 * mt, 2 * ks + a_hi);
          ldmatrix_x4(ab, qb + a);
          ldmatrix_x4(as, qb + QTILE + a);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(acc[mt][nt], as, bb[nt][0], bb[nt][1]);
            mma_tf32(acc[mt][nt], ab, bs[nt][0], bs[nt][1]);
            mma_tf32(acc[mt][nt], ab, bb[nt][0], bb[nt][1]);
          }
        }
      } else {
        // 16 elements of depth: each 16-byte unit h holds bf16 pairs
        // (2 tig, 2 tig + 1) of 8, which meet the mma's k = tig, tig + 4
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t bw[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            bw[nt][0] = b[nt][h] << 16;
            bw[nt][1] = b[nt][h] & 0xffff0000u;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t ab[4], as[4];
            const uint32_t a =
                swz<QKC>(a_row + 16 * mt, 4 * ks + 2 * h + a_hi);
            ldmatrix_x4(ab, qb + a);
            ldmatrix_x4(as, qb + QTILE + a);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              mma_tf32(acc[mt][nt], as, bw[nt][0], bw[nt][1]);
              mma_tf32(acc[mt][nt], ab, bw[nt][0], bw[nt][1]);
            }
          }
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
      fold_group<MT, false>(acc, bval, brow, r, scale, 0);
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
      fold_group<MT, true>(acc, bval, brow, r, scale, vbits);
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
          id[h] = static_cast<int>(
              static_cast<long long>(brow[mt][nt][i]) * LANES + lane0 + h +
              id_base);
        }
        *reinterpret_cast<float2*>(vals + out + lane0) = make_float2(v[0], v[1]);
        *reinterpret_cast<int2*>(ids + out + lane0) = make_int2(id[0], id[1]);
      }
    }
}

// shared memory of a block: the resident split query tile and the ring, or
// a ring whose stages carry the split query chunk
size_t smem_bytes(int mt, int qh, bool cbf16, int nkc) {
  const size_t qtile = static_cast<size_t>(2 * mt * 16) * (cbf16 ? 2 : 1) * KC;
  const size_t stage = LANES * KC + SCALE_BYTES;
  return qh == Q_SMEM ? nkc * 2 * qtile + STAGES * stage
                      : STAGES * (stage + 2 * qtile);
}

template <int MT, int QH, bool CBF16>
cudaError_t launch_tile(const uint8_t* corpus, long long ld, int db,
                        const float* queries, int q_count, int d,
                        const float* inv, const uint8_t* mask,
                        long long valid_n, int nb, int block_rows, int nseg,
                        int rows_total, int copy, float* vals, int* ids,
                        cudaStream_t stream) {
  auto kernel = scan_tf32_kernel<MT, QH, CBF16>;
  // above 48 KB of dynamic shared memory needs an opt-in (a host-side
  // attribute of the function, cheap to set on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  constexpr int QT = 2 * MT * 16;
  const dim3 grid((q_count + QT - 1) / QT, nb * nseg);
  const size_t smem = smem_bytes(MT, QH, CBF16, (db + KC - 1) / KC);
  kernel<<<grid, THREADS, smem, stream>>>(corpus, ld, db, queries, q_count, d,
                                          inv, mask, valid_n, block_rows, nseg,
                                          rows_total, copy, vals, ids);
  return cudaGetLastError();
}

template <bool CBF16>
cudaError_t launch_corpus(const uint8_t* corpus, long long ld, int db,
                          const float* queries, int q_count, int d,
                          const float* inv, const uint8_t* mask,
                          long long valid_n, int nb, int block_rows, int nseg,
                          int rows_total, int copy, float* vals, int* ids,
                          cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nkc = (db + KC - 1) / KC;
  // 64-query tiles where they leave no SM without a block and fit
  const long long segs = static_cast<long long>(nb) * nseg;
  const bool wide = (q_count + 63) / 64 * segs >= sms;
#define TILE_ARGS corpus, ld, db, queries, q_count, d, inv, mask, valid_n, \
                  nb, block_rows, nseg, rows_total, copy, vals, ids, stream
  if (wide && smem_bytes(2, Q_SMEM, CBF16, nkc) <= SMEM_MAX)
    return launch_tile<2, Q_SMEM, CBF16>(TILE_ARGS);
  if (wide && smem_bytes(2, Q_RING, CBF16, nkc) <= SMEM_MAX)
    return launch_tile<2, Q_RING, CBF16>(TILE_ARGS);
  if (smem_bytes(1, Q_SMEM, CBF16, nkc) <= SMEM_MAX)
    return launch_tile<1, Q_SMEM, CBF16>(TILE_ARGS);
  return launch_tile<1, Q_RING, CBF16>(TILE_ARGS);
#undef TILE_ARGS
}

}  // namespace

// The f32 branch of fused_scan_launch (fused_scan.cu), which checks the grid
// arguments and derives rows_total: an f32 corpus or (corpus_bf16) a bf16
// one, f32 queries. ld and d count elements here.
cudaError_t fused_scan_tf32(const void* corpus, bool corpus_bf16,
                            long long ld, const void* queries, int q_count,
                            int d, const float* inv, const uint8_t* mask,
                            long long valid_n, int nb, int block_rows,
                            int nseg, int rows_total, float* vals, int* ids,
                            cudaStream_t stream) {
  const auto c = static_cast<const uint8_t*>(corpus);
  const auto q = static_cast<const float*>(queries);
  const auto cp = reinterpret_cast<uintptr_t>(c);
  const int es = corpus_bf16 ? 2 : 4;
  if (d <= 0 || cp % es || reinterpret_cast<uintptr_t>(q) % 4)
    return cudaErrorInvalidValue;
  const long long ldb = es * ld;
  const int db = es * d;
  int copy = COPY_PLAIN;
  if (db % 16 == 0 && ldb % 16 == 0 && cp % 16 == 0)
    copy = COPY16;
  else if (db % 4 == 0 && ldb % 4 == 0 && cp % 4 == 0)
    copy = COPY4;
  // an f32 row takes at least the 4-byte copies; only bf16 reaches
  // COPY_PLAIN
  if (corpus_bf16)
    return launch_corpus<true>(c, ldb, db, q, q_count, d, inv, mask, valid_n,
                               nb, block_rows, nseg, rows_total, copy, vals,
                               ids, stream);
  return launch_corpus<false>(c, ldb, db, q, q_count, d, inv, mask, valid_n,
                              nb, block_rows, nseg, rows_total, copy, vals,
                              ids, stream);
}
