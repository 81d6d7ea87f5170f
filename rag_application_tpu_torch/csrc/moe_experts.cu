// Routed experts of a mixture-of-experts layer as grouped products, for
// Hopper (sm_90a).
//
// Replaces no kernel of the JAX package (it has no expert layer): these are
// the routed SwiGLU experts of DeepSeek-style decoders, launched by
// ops/moe.py::moe_experts. The pairs (token, expert) arrive sorted by expert
// and padded per expert to whole blocks of BM rows (ops/moe.py::align), so
// every block of rows belongs to one expert e = block_expert[block] (-1 for
// the blocks past the last expert's run, which return at once). Two kernels:
//   moe_gate_up: h[r, n] = bf16(silu(g) * u), g = bf16(x[t] . Wg[e][:, n] *
//                sg[e, n]), u likewise with Wu, su; t = pair[r] / topk, and a
//                pad row (pair[r] == pairs) reads zeros;
//   moe_down:    y[r, n] = bf16(h[r] . Wd[e][:, n] * sd[e, n]).
// The dots' sums in f32, silu and the product in f32: the rounding points of
// the plain version (ops/moe.py::moe_experts_plain). The weights are int8
// codes (E, K, N) with one f32 scale per output channel (E, N).
//
// What bounds it on the H100: at a decode step (64 tokens x 6 pairs over 64
// experts, 16-row blocks) bytes, since nearly every expert is reached and
// each expert's 8.65 MB of int8 codes is read once per block of its rows;
// at a prefill of thousands of tokens (~300 rows an expert, 64-row blocks)
// the products.
//
// Design: one 128-thread block owns BM rows and BN = 64 output columns of
// one expert (both the gate's and the up's columns in moe_gate_up), and
// walks the depth K in stages of BK = 64. A stage's activations (bf16, 16
// bytes a load) and int8 weights (16 codes a load) are loaded into
// registers while the tensor cores work on the stage before, then stored to
// shared memory, the weights converted once to bf16 on the way (a byte
// permute builds the f32 2^23 + (v + 128), a subtraction leaves v, and
// cvt.rn.bf16x2.f32 packs two: every int8 is exact in bf16). Shared rows are
// padded by 16 bytes, so the 8 rows an ldmatrix phase reads fall in 8
// different bank groups. The products run on mma.sync.m16n8k16 bf16 -> f32:
// A (rows x depth) by ldmatrix.x4 and B (depth x columns, stored depth-major
// as the weights are) by ldmatrix.x4.trans. The four warps split the tile
// 1 x 4 at BM 16 (each 16 x 16) and 2 x 2 at BM 64 (each 32 x 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BN = 64;              // output columns of a block
constexpr int BK = 64;              // depth of a stage
constexpr int A_ROW = BK * 2 + 16;  // bytes of an activation row in shared
constexpr int W_ROW = BN * 2 + 16;  // bytes of a weight row (one depth)

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // cvt.rn.bf16x2.f32
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One block's tile: rows [m0, m0 + BM) of the sorted pairs (activations a,
// row stride sa; with `pair`, row r reads a's row pair[r] / topk, or zeros
// where pair[r] >= pairs), columns [n0, n0 + BN) of NW weights of expert e
// (codes (K, N) row-major, scales (N,)). NW 2: the SwiGLU of the two
// products; NW 1: the scaled product. Writes bf16 rows of `out` (stride so).
template <int BM, int NW>
__device__ __forceinline__ void grouped_tile(
    const __nv_bfloat16* __restrict__ a, long long sa,
    const long long* __restrict__ pair, long long pairs, int topk,
    const long long* __restrict__ block_expert,
    const int8_t* __restrict__ w0, const float* __restrict__ s0,
    const int8_t* __restrict__ w1, const float* __restrict__ s1, int K, int N,
    __nv_bfloat16* __restrict__ out, long long so) {
  constexpr int WM = BM >= 64 ? 2 : 1;  // warps along the rows
  constexpr int WN = 4 / WM;            // and along the columns
  constexpr int MT = BM / WM / 16;      // 16-row tiles of a warp
  constexpr int NT = BN / WN / 8;       // 8-column tiles of a warp
  constexpr int A_UNITS = BM * BK / 8 / THREADS;   // 16-byte bf16 loads
  constexpr int W_UNITS = BK * BN / 16 / THREADS;  // 16-byte int8 loads
  static_assert(MT >= 1 && NT % 2 == 0, "warp tiles");
  static_assert(A_UNITS >= 1 && W_UNITS >= 1, "loads per thread");
  __shared__ __align__(16) unsigned char a_s[BM * A_ROW];
  __shared__ __align__(16) unsigned char w_s[NW][BK * W_ROW];

  const long long e = block_expert[blockIdx.x];
  if (e < 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // each thread's activation rows are the same at every stage
  const __nv_bfloat16* a_src[A_UNITS];
#pragma unroll
  for (int i = 0; i < A_UNITS; ++i) {
    const int u = tid + i * THREADS;
    const int r = u / (BK / 8), c = (u % (BK / 8)) * 8;
    const long long row = m0 + r;
    if (pair != nullptr) {
      const long long p = pair[row];
      a_src[i] = p < pairs ? a + (p / topk) * sa + c : nullptr;
    } else {
      a_src[i] = a + row * sa + c;
    }
  }
  const int8_t* w_src[NW];
  w_src[0] = w0 + e * K * N + n0;
  if constexpr (NW == 2) w_src[1] = w1 + e * K * N + n0;

  uint4 a_r[A_UNITS];
  uint4 w_r[NW][W_UNITS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_UNITS; ++i)
      a_r[i] = a_src[i] != nullptr
                   ? *reinterpret_cast<const uint4*>(a_src[i] + k0)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int i = 0; i < W_UNITS; ++i) {
        const int u = tid + i * THREADS;
        const int r = u / (BN / 16), c = (u % (BN / 16)) * 16;
        w_r[j][i] = *reinterpret_cast<const uint4*>(
            w_src[j] + static_cast<long long>(k0 + r) * N + c);
      }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_UNITS; ++i) {
      const int u = tid + i * THREADS;
      const int r = u / (BK / 8), c = (u % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(a_s + r * A_ROW + c * 2) = a_r[i];
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int i = 0; i < W_UNITS; ++i) {
        const int u = tid + i * THREADS;
        const int r = u / (BN / 16), c = (u % (BN / 16)) * 16;
        const uint4 v = w_r[j][i];
        const uint2 b0 = s8x4_to_bf16x4(v.x), b1 = s8x4_to_bf16x4(v.y);
        const uint2 b2 = s8x4_to_bf16x4(v.z), b3 = s8x4_to_bf16x4(v.w);
        uint4* dst = reinterpret_cast<uint4*>(w_s[j] + r * W_ROW + c * 2);
        dst[0] = make_uint4(b0.x, b0.y, b1.x, b1.y);
        dst[1] = make_uint4(b2.x, b2.y, b3.x, b3.y);
      }
  };

  float acc[NW][MT][NT][4];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][mt][nt][q] = 0.0f;

  const uint32_t a_base = smem_addr(a_s);
  uint32_t w_base[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) w_base[j] = smem_addr(w_s[j]);
  // ldmatrix: lane l gives the address of row (l & 7) of matrix l >> 3;
  // matrices 0-3 are (rows 0-7, depth 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15) for A, and (depth 0-7, cols 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15) for B, which .trans turns into two column tiles'
  // fragments
  const int l_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int l_off = (lane >> 4) * 8;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], a_base + (wm * (BM / WM) + mt * 16 + l_row) *
                                         A_ROW + (kk + l_off) * 2);
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, w_base[j] + (kk + l_row) * W_ROW +
                                   (wn * (BN / WN) + np * 16 + l_off) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[j][mt][2 * np], af[mt], b[0], b[1]);
            mma_bf16(acc[j][mt][2 * np + 1], af[mt], b[2], b[3]);
          }
        }
    }
    if (more) {
      __syncthreads();
      store();
      __syncthreads();
    }
  }

  // mma fragment: c[0], c[1] at (row gid, cols 2 tig, 2 tig + 1), c[2],
  // c[3] at row gid + 8
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * (BN / WN) + nt * 8 + tig * 2;
      const float2 sa0 = *reinterpret_cast<const float2*>(s0 + e * N + col);
      float2 sa1 = make_float2(0.0f, 0.0f);
      if constexpr (NW == 2)
        sa1 = *reinterpret_cast<const float2*>(s1 + e * N + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm * (BM / WM) + mt * 16 + gid + h * 8;
        float v0, v1;
        if constexpr (NW == 2) {
          const float g0 = round_bf16(acc[0][mt][nt][2 * h] * sa0.x);
          const float g1 = round_bf16(acc[0][mt][nt][2 * h + 1] * sa0.y);
          const float u0 = round_bf16(acc[1][mt][nt][2 * h] * sa1.x);
          const float u1 = round_bf16(acc[1][mt][nt][2 * h + 1] * sa1.y);
          v0 = g0 / (1.0f + expf(-g0)) * u0;
          v1 = g1 / (1.0f + expf(-g1)) * u1;
        } else {
          v0 = acc[0][mt][nt][2 * h] * sa0.x;
          v1 = acc[0][mt][nt][2 * h + 1] * sa0.y;
        }
        *reinterpret_cast<uint32_t*>(out + row * so + col) =
            bf16x2_bits(v0, v1);
      }
    }
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
    moe_gate_up(const __nv_bfloat16* __restrict__ x, long long sx,
                const long long* __restrict__ pair, long long pairs, int topk,
                const long long* __restrict__ block_expert,
                const int8_t* __restrict__ wg, const float* __restrict__ sg,
                const int8_t* __restrict__ wu, const float* __restrict__ su,
                int K, int N, __nv_bfloat16* __restrict__ h, long long sh) {
  grouped_tile<BM, 2>(x, sx, pair, pairs, topk, block_expert, wg, sg, wu, su,
                      K, N, h, sh);
}

template <int BM>
__global__ void __launch_bounds__(THREADS)
    moe_down(const __nv_bfloat16* __restrict__ h, long long sh,
             const long long* __restrict__ block_expert,
             const int8_t* __restrict__ wd, const float* __restrict__ sd,
             int K, int N, __nv_bfloat16* __restrict__ y, long long sy) {
  grouped_tile<BM, 1>(h, sh, nullptr, 0, 1, block_expert, wd, sd, nullptr,
                      nullptr, K, N, y, sy);
}

template <int BM>
cudaError_t launch_both(const __nv_bfloat16* x, long long sx,
                        const long long* pair, long long pairs, int topk,
                        const long long* block_expert, int blocks, int H,
                        int F, const int8_t* wg, const float* sg,
                        const int8_t* wu, const float* su, const int8_t* wd,
                        const float* sd, __nv_bfloat16* h, __nv_bfloat16* y,
                        cudaStream_t st) {
  moe_gate_up<BM><<<dim3(blocks, F / BN), THREADS, 0, st>>>(
      x, sx, pair, pairs, topk, block_expert, wg, sg, wu, su, H, F, h, F);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down<BM><<<dim3(blocks, H / BN), THREADS, 0, st>>>(
      h, F, block_expert, wd, sd, F, H, y, H);
  return cudaGetLastError();
}

}  // namespace

// x (T, H) bf16 with row stride sx (elements); pair (blocks * block_rows,)
// int64, the pair at each sorted row (>= pairs at pad rows), token = pair /
// topk; block_expert (blocks,) int64, -1 for empty blocks; wg, wu (E, H, F)
// and wd (E, F, H) int8 codes with sg, su (E, F) and sd (E, H) f32 scales;
// h (blocks * block_rows, F) and y (blocks * block_rows, H) bf16 outputs,
// contiguous. block_rows is 16 or 64; H and F multiples of 64; x, the codes
// and h 16-byte aligned and sx a multiple of 8. Returns a cudaError_t (0 =
// both kernels launched).
extern "C" int moe_experts_launch(const void* x, long long sx,
                                  const long long* pair, long long pairs,
                                  int topk, const long long* block_expert,
                                  int blocks, int block_rows, int H, int F,
                                  const int8_t* wg, const float* sg,
                                  const int8_t* wu, const float* su,
                                  const int8_t* wd, const float* sd, void* h,
                                  void* y, void* stream) {
  if (blocks <= 0 || topk <= 0 || pairs < 0 || H <= 0 || F <= 0 ||
      H % BK || H % BN || F % BK || F % BN || sx % 8 || sx < H ||
      F / BN > 65535 || H / BN > 65535)
    return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_rows == 16)
    return launch_both<16>(xb, sx, pair, pairs, topk, block_expert, blocks, H,
                           F, wg, sg, wu, su, wd, sd, hb, yb, st);
  if (block_rows == 64)
    return launch_both<64>(xb, sx, pair, pairs, topk, block_expert, blocks, H,
                           F, wg, sg, wu, su, wd, sd, hb, yb, st);
  return cudaErrorInvalidValue;
}
