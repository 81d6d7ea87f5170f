// T=1 GQA flash-decode over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces: rag_application_tpu/ops/decode_attn.py::_kernel (the Pallas TPU
// kernel launched by decode_attend_int8). For every batch row b, kv head k
// and query group g it computes, over the S cache slots,
//   score[s] = (q[b,k,g,:] . k8[b,s,k,:]) * ks[b,s,k] * (1/sqrt(hd))
//              (-1e30 where mask[b,s] is false)
//   p[s]     = exp(score[s] - m) * mask[b,s]        (m: running max)
//   out      = sum_s bf16(p[s] * vs[b,s,k]) * v8[b,s,k,:] / max(sum_s p, 1e-30)
// with the dots and sums in f32, the rounding points of the reference's
// kernel body (decode_attn.py:112-142). A row with no visible slot gives 0.
// The reference's block-diagonal query and diagonal extraction exist for
// the TPU's matrix lanes; here each block indexes its kv head directly.
//
// What bounds it on the H100: bytes. At the main decode shape (B 64, S 1024,
// KVH 4, G 8, hd 64) one call reads 33.6 MB of int8 K/V and 2.1 MB of
// scales, ~10.7 us at 3.35 TB/s; the dots are ~0.5 GFLOP.
//
// What bounded the first design (0.099 ms at that shape): int->float
// conversions. It kept K and V as int8 in shared memory and converted each
// byte with one I2F per use, once for every query head that read it: G = 8
// conversions a byte, 268M a call. I2F issues at 16 a clock on an SM, a
// quarter of the FMA rate, so they alone took ~65 of its 99 us.
//
// What this design does about it: flash-decoding as before. The S axis is
// cut into chunks of `chunk` slots; one 128-thread block owns one (chunk,
// kv head, row) triple, so the grid has B*KVH*ceil(S/chunk) blocks. A block
// first reads its chunk's mask: a chunk with no visible slot writes the
// empty partial and loads nothing. Otherwise every thread issues its
// 16-byte loads of the chunk's K and V rows (a slot's hd bytes are
// contiguous, and a warp's loads cover whole 32-byte sectors), then those
// of the scales and q, and only then stores anything (a store waits for
// its load, and would hold back every load issued after it).
// Each K and V byte is converted once, into bf16 in shared memory: a byte
// permute builds the f32 2^23 + (v + 128), one subtraction leaves v, and
// cvt.rn.bf16x2.f32 packs two (integer and float pipes; every int8 is exact
// in bf16). K and V rows are padded by 16 bytes, so the 8 rows an ldmatrix
// phase reads at one column fall in 8 different bank groups. Both products then
// run on mma.sync.m16n8k16 bf16 -> f32 with the query heads on n (G < 8
// pads the tile with zero rows, G > 8 takes tiles of 8): scores^T = K tile
// . q^T, A from K by ldmatrix.x4 and B from q [head][depth]; after the
// chunk's softmax (its rounding points as before) out^T = V^T tile . p^T, A
// from V by ldmatrix.x4.trans and B from bf16(p * v_scale) [head][slot].
// The tensor core adds exact bf16 x bf16 products in f32, so only the order
// of the f32 sums differs from the plain version. With more than one chunk
// the blocks write (max, sum, acc) partials and a second kernel merges
// them; with one chunk the first kernel writes the output itself.
//
// What bounds it now (H100 80GB HBM3 at 700 W, main decode shape, 0.032 ms
// with its caches cold): not bytes (0.011 ms), conversions or products.
// Copies with one part cut save 0.0004 ms (no conversion), 0.004 (no
// products) and 0.0055 (no K/V loads) of the split kernel's 0.030: the rest
// is each block's chain of waits (its mask, its loads, four barriers around
// short phases) and the merge's 0.004. So the design shortens the chain:
// every load of a thread before its first store, the softmax's warps taking
// two heads at a time, the chunk's max taken in the scores epilogue, and q
// rows unpadded so that 5 blocks (45,504 bytes each) share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 4;  // 16-byte K and V units a thread has in flight
constexpr int MAX_CHUNK = 256;
constexpr int MT_WARP = MAX_CHUNK / 16 / WARPS;  // slot tiles a warp scores
constexpr int SCALES = MAX_CHUNK / THREADS;      // slots' scales a thread loads
static_assert(WARPS == 4, "the score rows' pad holds one max a warp");
constexpr float NEG = -1.0e30f;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Four int8 (one word, lowest byte first) as four bf16, exactly: the byte
// v + 128 becomes the low mantissa byte of the f32 2^23 + (v + 128).
__device__ __forceinline__ uint2 s8x4_to_bf16x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float BIAS = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - BIAS;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - BIAS;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - BIAS;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - BIAS;
  return make_uint2(bf16x2_bits(f0, f1), bf16x2_bits(f2, f3));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
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

// Bytes of one K or V row in shared memory: hd bf16 and 16 bytes of
// padding, so 8 rows read at one column fall in 8 different bank groups (q
// rows, read by one ldmatrix a k-step, go unpadded).
__host__ __device__ inline size_t row_bytes(int hd) { return 2 * hd + 16; }

// Query heads padded to whole n-tiles of 8.
__host__ __device__ inline int heads_padded(int g) { return (g + 7) / 8 * 8; }

// Shared memory of one block, in bytes; the regions in this order.
__host__ __device__ inline size_t smem_bytes(int g, int hd, int chunk) {
  const size_t gp = heads_padded(g);
  return 2 * chunk * row_bytes(hd)                     // K, V rows (bf16)
         + gp * 2 * static_cast<size_t>(hd)              // q (bf16)
         + gp * (2 * static_cast<size_t>(chunk) + 16)    // bf16(p * v_scale)
         + static_cast<size_t>(g) * (chunk + WARPS) * 4  // scores (f32)
         + 2 * static_cast<size_t>(chunk) * 4            // k, v scales
         + 2 * static_cast<size_t>(g) * 4                // (max, sum)
         + chunk;                                        // mask
}

// grid (n_split, KVH, B). part: (B, KVH, n_split, G, hd + 2) f32 partials
// [max, sum, acc...], unused when n_split == 1 (out written directly).
// 5 blocks a SM: the registers are held to 102 a thread.
__global__ void __launch_bounds__(THREADS, 5)
decode_attn_split(const __nv_bfloat16* __restrict__ q,
                  const int8_t* __restrict__ k8,
                  const float* __restrict__ ks,
                  const int8_t* __restrict__ v8,
                  const float* __restrict__ vs,
                  const uint8_t* __restrict__ mask, int S, int KVH, int G,
                  int hd, int chunk, float inv_sqrt_hd,
                  float* __restrict__ part, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int s0 = j * chunk;
  const int n = min(chunk, S - s0);  // a multiple of 32
  const int gp = heads_padded(G);
  const int rb = static_cast<int>(row_bytes(hd));
  const int pb = 2 * chunk + 16;     // p row bytes
  const int pitch = chunk + WARPS;   // score row: slots, then warp maxima
  unsigned char* kc = smem;
  unsigned char* vc = kc + chunk * rb;
  unsigned char* qs = vc + chunk * rb;
  unsigned char* ps = qs + gp * 2 * hd;
  float* sc = reinterpret_cast<float*>(ps + gp * pb);
  float* kss = sc + G * pitch;
  float* vss = kss + chunk;
  float* stat = vss + chunk;
  uint8_t* mk = reinterpret_cast<uint8_t*>(stat + 2 * G);

  const long long srow = static_cast<long long>(b) * S + s0;
  const long long bk = static_cast<long long>(b) * KVH + kvh;
  int any = 0;
  for (int s = threadIdx.x; s < n; s += THREADS) {
    const uint8_t m = mask[srow + s];
    mk[s] = m;
    any |= m;
  }
  if (!__syncthreads_or(any)) {
    // no visible slot: the partial (NEG, 0, 0...), which the merge weighs
    // by exp(NEG - m) = 0; a row with no visible slot at all gives 0
    for (int i = threadIdx.x; i < G * (hd + 2); i += THREADS) {
      const int g = i / (hd + 2), c = i - g * (hd + 2);
      if (n_split == 1) {
        if (c >= 2) out[(bk * G + g) * hd + c - 2] = __float2bfloat16_rn(0.0f);
      } else {
        part[((bk * n_split + j) * G + g) * (hd + 2) + c] = c == 0 ? NEG : 0.0f;
      }
    }
    return;
  }

  // K and V rows: every load of a batch issued before its conversions
  const long long row = static_cast<long long>(KVH) * hd;  // slot pitch
  const long long base = srow * row + static_cast<long long>(kvh) * hd;
  const int per_row = hd / 16;
  const int units = n * per_row;
  for (int i0 = 0; i0 < units; i0 += LOADS * THREADS) {
    int4 kx[LOADS], vx[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < units) {
        const int s = i / per_row, c = i - s * per_row;
        const long long off = base + s * row + c * 16;
        kx[u] = *reinterpret_cast<const int4*>(k8 + off);
        vx[u] = *reinterpret_cast<const int4*>(v8 + off);
      }
    }
    if (i0 == 0) {
      // scales and q while the first batch is in flight, every load before
      // any store (a store between two loads would hold the second back)
      float ksr[SCALES], vsr[SCALES];
#pragma unroll
      for (int r = 0; r < SCALES; ++r) {
        const int s = threadIdx.x + r * THREADS;
        if (s < n) {
          ksr[r] = ks[(srow + s) * KVH + kvh];
          vsr[r] = vs[(srow + s) * KVH + kvh];
        }
      }
      const int qrow = hd / 8;  // 16-byte units of a q row
      const int qunits = G * qrow;
      const int4* qb = reinterpret_cast<const int4*>(q + bk * G * hd);
      int4 qx = make_int4(0, 0, 0, 0);
      if (threadIdx.x < qunits) qx = qb[threadIdx.x];
#pragma unroll
      for (int r = 0; r < SCALES; ++r) {
        const int s = threadIdx.x + r * THREADS;
        if (s < n) {
          kss[s] = ksr[r];
          vss[s] = vsr[r];
        }
      }
      for (int i = threadIdx.x; i < qunits; i += THREADS) {
        if (i >= THREADS) qx = qb[i];
        const int g = i / qrow, u = i - g * qrow;
        *reinterpret_cast<int4*>(qs + g * 2 * hd + 16 * u) = qx;
      }
      // q rows [head][depth]; the padding heads' q and p rows are zero
      for (int i = threadIdx.x; i < (gp - G) * hd / 8; i += THREADS)
        reinterpret_cast<int4*>(qs + G * 2 * hd)[i] = make_int4(0, 0, 0, 0);
      for (int i = threadIdx.x; i < (gp - G) * pb / 16; i += THREADS)
        reinterpret_cast<int4*>(ps + G * pb)[i] = make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int i = i0 + u * THREADS + threadIdx.x;
      if (i < units) {
        const int s = i / per_row, c = i - s * per_row;
        const uint2 k0 = s8x4_to_bf16x4(kx[u].x), k1 = s8x4_to_bf16x4(kx[u].y);
        const uint2 k2 = s8x4_to_bf16x4(kx[u].z), k3 = s8x4_to_bf16x4(kx[u].w);
        const uint2 v0 = s8x4_to_bf16x4(vx[u].x), v1 = s8x4_to_bf16x4(vx[u].y);
        const uint2 v2 = s8x4_to_bf16x4(vx[u].z), v3 = s8x4_to_bf16x4(vx[u].w);
        uint4* kd = reinterpret_cast<uint4*>(kc + s * rb + c * 32);
        uint4* vd = reinterpret_cast<uint4*>(vc + s * rb + c * 32);
        kd[0] = make_uint4(k0.x, k0.y, k1.x, k1.y);
        kd[1] = make_uint4(k2.x, k2.y, k3.x, k3.y);
        vd[0] = make_uint4(v0.x, v0.y, v1.x, v1.y);
        vd[1] = make_uint4(v2.x, v2.y, v3.x, v3.y);
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment row, column pair
  // ldmatrix: lane l gives the address of row (l & 7) of matrix l >> 3
  const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lquad = lane >> 4;

  // scores^T (16 slots x 8 heads) = K tile (16 slots x 16 depth) . q^T per
  // mma; warp w takes the chunk's slot tiles w, w + 4, ...
  const int mtiles = n / 16;
  const uint32_t kc_s = smem_addr(kc), vc_s = smem_addr(vc);
  const uint32_t qs_s = smem_addr(qs), ps_s = smem_addr(ps);
  for (int g0 = 0; g0 < G; g0 += 8) {
    float acc[MT_WARP][4];
#pragma unroll
    for (int i = 0; i < MT_WARP; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    for (int k0 = 0; k0 < hd; k0 += 16) {
      uint32_t b0, b1;
      ldmatrix_x2(b0, b1, qs_s + ((g0 + lrow) * hd + k0 + lhalf * 8) * 2);
#pragma unroll
      for (int i = 0; i < MT_WARP; ++i) {
        const int mt = warp + i * WARPS;
        if (mt < mtiles) {
          uint32_t a[4];
          ldmatrix_x4(a, kc_s + (mt * 16 + lrow + lhalf * 8) * rb +
                             (k0 + lquad * 8) * 2);
          mma_bf16(acc[i], a, b0, b1);
        }
      }
    }
    // k_scale, then 1/sqrt(hd), then the mask, in the reference's order;
    // each warp's max of its slots per head goes to the head's row pad
    float hmax[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < MT_WARP; ++i) {
      const int mt = warp + i * WARPS;
      if (mt >= mtiles) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = mt * 16 + gid + 8 * r;
        const float scale = kss[s];
        const bool vis = mk[s];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = vis ? (acc[i][2 * r + c] * scale) * inv_sqrt_hd : NEG;
          const int g = g0 + 2 * tig + c;
          if (g < G) sc[g * pitch + s] = v;
          hmax[c] = fmaxf(hmax[c], v);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      for (int o = 4; o < 32; o <<= 1)
        hmax[c] = fmaxf(hmax[c], __shfl_xor_sync(0xffffffffu, hmax[c], o));
      const int g = g0 + 2 * tig + c;
      if (gid == 0 && g < G) sc[g * pitch + chunk + warp] = hmax[c];
    }
  }
  __syncthreads();

  // chunk softmax, one warp per query head, each warp taking two heads
  // at a time (their loads, exps and shuffles interleave); the chunk's max
  // is the max of the warps' maxima. The vis factor keeps a fully masked
  // chunk (m = NEG, exp(0) = 1) at p = 0
  for (int g0 = warp; g0 < G; g0 += 2 * WARPS) {
    const int g1 = g0 + WARPS < G ? g0 + WARPS : g0;  // g0 twice if alone
    const float* p0 = sc + g0 * pitch;
    const float* p1 = sc + g1 * pitch;
    float m0 = NEG, m1 = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      m0 = fmaxf(m0, p0[chunk + w]);
      m1 = fmaxf(m1, p1[chunk + w]);
    }
    __nv_bfloat16* r0 = reinterpret_cast<__nv_bfloat16*>(ps + g0 * pb);
    __nv_bfloat16* r1 = reinterpret_cast<__nv_bfloat16*>(ps + g1 * pb);
    float l0 = 0.0f, l1 = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float vis = mk[s] ? 1.0f : 0.0f, v = vss[s];
      const float e0 = expf(p0[s] - m0) * vis;
      const float e1 = expf(p1[s] - m1) * vis;
      l0 += e0;
      l1 += e1;
      r0[s] = __float2bfloat16_rn(e0 * v);
      r1[s] = __float2bfloat16_rn(e1 * v);
    }
    for (int o = 16; o > 0; o >>= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    if (lane == 0) {
      stat[2 * g0] = m0;
      stat[2 * g0 + 1] = l0;
      stat[2 * g1] = m1;
      stat[2 * g1 + 1] = l1;
    }
  }
  __syncthreads();

  // out^T (16 depth x 8 heads) = V^T tile (16 depth x 16 slots) . p^T per
  // mma; warp w takes the (depth tile, head tile) pairs w, w + 4, ...
  const int dtiles = hd / 16;
  for (int t = warp; t < dtiles * (gp / 8); t += WARPS) {
    const int d0 = (t % dtiles) * 16, g0 = (t / dtiles) * 8;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < n; k0 += 16) {
      uint32_t a[4], b0, b1;
      ldmatrix_x4_trans(a, vc_s + (k0 + lrow + lquad * 8) * rb +
                               (d0 + lhalf * 8) * 2);
      ldmatrix_x2(b0, b1, ps_s + (g0 + lrow) * pb + (k0 + lhalf * 8) * 2);
      mma_bf16(acc, a, b0, b1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int d = d0 + gid + 8 * r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int g = g0 + 2 * tig + c;
        if (g >= G) continue;
        if (n_split == 1) {
          const float l = fmaxf(stat[2 * g + 1], 1e-30f);
          out[(bk * G + g) * hd + d] =
              __float2bfloat16_rn(acc[2 * r + c] / l);
        } else {
          float* pp = part + ((bk * n_split + j) * G + g) * (hd + 2);
          if (d == 0) {
            pp[0] = stat[2 * g];
            pp[1] = stat[2 * g + 1];
          }
          pp[2 + d] = acc[2 * r + c];
        }
      }
    }
  }
}

// grid (B*KVH*G), hd threads: merge the n_split partials of one head.
__global__ void decode_attn_combine(const float* __restrict__ part,
                                    int n_split, int G, int hd,
                                    __nv_bfloat16* __restrict__ out) {
  const long long head = blockIdx.x;  // (b*KVH + kvh)*G + g
  const long long bk = head / G;
  const int g = static_cast<int>(head - bk * G);
  const long long step = static_cast<long long>(G) * (hd + 2);
  const float* pp = part + (bk * n_split * G + g) * (hd + 2);
  const int d = threadIdx.x;
  float m = NEG;
  for (int j = 0; j < n_split; ++j) m = fmaxf(m, pp[j * step]);
  float l = 0.0f, acc = 0.0f;
  for (int j = 0; j < n_split; ++j) {
    const float* pj = pp + j * step;
    const float w = expf(pj[0] - m);
    l = fmaf(pj[1], w, l);
    acc = fmaf(pj[2 + d], w, acc);
  }
  out[head * hd + d] = __float2bfloat16_rn(acc / fmaxf(l, 1e-30f));
}

// decode_attn_split may take up to SMEM_MAX of dynamic shared memory: above
// 48 KB needs an opt-in (a host-side attribute of the function, cheap to set
// on every launch).
cudaError_t opt_in_smem() {
  return cudaFuncSetAttribute(decode_attn_split,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(SMEM_MAX));
}

}  // namespace

// q (B, KVH, G, hd) bf16, k8/v8 (B, S, KVH, hd) int8, all 16-byte aligned;
// ks/vs (B, S, KVH) f32; mask (B, S) bool; all contiguous. S is a multiple
// of 32, chunk a multiple of 32 up to 256, hd a multiple of 16 (<= 1024),
// and the block's shared memory (smem_bytes) at most 227 KB. part:
// B*KVH*n_split*G*(hd+2) f32 scratch with n_split = ceil(S/chunk), may be
// NULL when n_split == 1. out (B, KVH, G, hd) bf16. Returns a cudaError_t
// (0 = both kernels launched).
extern "C" int decode_attn_launch(const void* q, const int8_t* k8,
                                  const float* ks, const int8_t* v8,
                                  const float* vs, const uint8_t* mask,
                                  int B, int S, int KVH, int G, int hd,
                                  int chunk, float inv_sqrt_hd, float* part,
                                  void* out, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || G <= 0 || hd <= 0 || hd % 16 ||
      hd > 1024 || S % 32 || chunk <= 0 || chunk % 32 || chunk > MAX_CHUNK ||
      B > 65535 || KVH > 65535)
    return cudaErrorInvalidValue;
  const int n_split = (S + chunk - 1) / chunk;
  if (n_split > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, hd, chunk);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem();
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_attn_split<<<dim3(n_split, KVH, B), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), k8, ks, v8, vs, mask, S, KVH, G,
      hd, chunk, inv_sqrt_hd, part, static_cast<__nv_bfloat16*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long heads = static_cast<long long>(B) * KVH * G;
  if (heads > 2147483647LL) return cudaErrorInvalidValue;
  decode_attn_combine<<<static_cast<unsigned>(heads), hd, 0, st>>>(
      part, n_split, G, hd, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}

// Blocks of decode_attn_split one SM holds at once for a (G, hd, chunk)
// geometry (CUDA's occupancy calculator), or minus a cudaError_t.
extern "C" int decode_attn_blocks_per_sm(int G, int hd, int chunk) {
  if (G <= 0 || hd <= 0 || chunk <= 0) return -cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, hd, chunk);
  if (smem > SMEM_MAX) return -cudaErrorInvalidValue;
  cudaError_t err = opt_in_smem();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, decode_attn_split, THREADS, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
