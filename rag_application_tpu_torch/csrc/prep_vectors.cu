// Insert-time prep pass for Hopper (sm_90a): one read of an insert batch
// gives every derived view the dense index stores, written in place into
// the index's planes.
//
// Replaces: rag_application_tpu/ops/quant.py::_prep_kernel (the Pallas TPU
// kernel launched by prepare_vectors). For every row x of the (N, d) f32
// batch it computes
//   inv    = 1 / sqrt(max(sum_c x[c]^2, 1e-12)),   xn = x * inv
//   norm   = bf16(xn)                              (round to nearest even)
//   int8   = clip(rint(xn * 127), -127, 127)       (round half to even)
//   inv_j  = 1 / sqrt(max(sum_{c < dims[j]} xn[c]^2, 1e-12))  for each j
// and sets the row's live flag. The prefix sums take the squares of the
// NORMALIZED row, as the reference does. A zero row gives inv = 1e6, zeros
// and inv_j = 1e6. The Pallas wrapper pads the batch to its row block
// with 1.0; here every row is real and nothing is padded. Each output
// pointer may be NULL (that plane is not stored).
//
// Bit for bit with the plain version (`ops/quant.py::prepare_vectors_xla`):
// every sum is a chain of f32 adds in one fixed order (element c is added
// by lane (c / 4) % 32 in increasing c, then the 32 lane sums add by
// halves, as the butterfly of shuffles below), squares and products are
// single f32 multiplies (no FMA contraction: __fmul_rn / __fadd_rn), and
// 1 / sqrt is taken in f64 and rounded once to f32. The plain version
// repeats that order with torch ops, so the two give the same bits.
//
// What bounds it on the H100: bytes. A row reads 4d bytes and writes
// 2d (bf16) + d (int8) + 4M bytes; at a 131,072 x 768 slab with M = 3 that
// is 706 MB, 0.211 ms at 3.35 TB/s. The arithmetic is a few flops per
// element. At a 64-row insert (one document) the bytes take 0.1 us and
// what is left is the chain of latencies of one row's warp.
//
// What this design does about it: one warp per row, neighbouring lanes on
// neighbouring 16-byte vectors. When d <= 1024 and the rows align, a
// lane's float4s (six at d = 768) are all loaded at once and stay in
// registers from the sum of squares to the stores, so the row is read
// once and its loads overlap; otherwise the row is read again from L1 for
// the second pass. Blocks hold 1 to 8 rows, the fewest that still give
// every SM 4 blocks, so a 64-row insert spreads over 64 SMs while a slab
// keeps 8-row blocks. The prefix dims are taken in groups of 8 registers,
// so any count of them works (one group for the repo's three).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_ROWS_PER_BLOCK = 8;
constexpr int MAX_V = 8;      // float4 a lane held in registers: d <= 1024
constexpr int GROUP = 8;      // prefix-dim accumulators held per pass
constexpr int MAX_DIMS = 64;  // prefix dims per launch

struct Dims {
  int n;
  int d[MAX_DIMS];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 1 / sqrt(max(s, 1e-12)): f64 sqrt and division are correctly rounded,
// and the result is rounded once to f32
__device__ __forceinline__ float inv_norm(float s) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(fmaxf(s, 1e-12f))));
}

__device__ __forceinline__ int8_t to_int8(float xn) {
  const float r =
      fminf(fmaxf(rintf(__fmul_rn(xn, 127.0f)), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Adds sq to the accumulators of the prefix dims [g, g + GROUP) that
// element c lies in.
__device__ __forceinline__ void add_prefix(float (&acc)[GROUP],
                                           const Dims& dims, int g, int c,
                                           float sq) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j)
    if (g + j < dims.n && c < dims.d[g + j]) acc[j] = __fadd_rn(acc[j], sq);
}

// Lane 0 writes the inverse prefix norms of group g.
__device__ __forceinline__ void store_prefix(float (&acc)[GROUP],
                                             const Dims& dims, int g,
                                             int lane, float* inv_row) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    if (g + j >= dims.n) break;
    const float t = inv_norm(warp_sum(acc[j]));
    if (lane == 0) inv_row[g + j] = t;
  }
}

// d % 4 == 0, d <= 128 * NV, x 16-byte and planes 8/4-byte aligned: the
// row's float4s stay in registers between the passes.
template <int NV>
__global__ void __launch_bounds__(32 * MAX_ROWS_PER_BLOCK)
prep_vectors_reg(const float* __restrict__ x, long long n, int d, Dims dims,
              __nv_bfloat16* __restrict__ norm, int8_t* __restrict__ q8,
              float* __restrict__ inv_out, uint8_t* __restrict__ live) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  const int n4 = d / 4;
  const float4* xv = reinterpret_cast<const float4*>(x + row * d);
  float4 a[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int v = lane + 32 * k;
    a[k] = v < n4 ? __ldg(xv + v) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the sum of squares, in element order (absent vectors add +0)
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    s = __fadd_rn(s, __fmul_rn(a[k].x, a[k].x));
    s = __fadd_rn(s, __fmul_rn(a[k].y, a[k].y));
    s = __fadd_rn(s, __fmul_rn(a[k].z, a[k].z));
    s = __fadd_rn(s, __fmul_rn(a[k].w, a[k].w));
  }
  const float inv = inv_norm(warp_sum(s));

  // normalize and store both planes
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    a[k].x = __fmul_rn(a[k].x, inv);
    a[k].y = __fmul_rn(a[k].y, inv);
    a[k].z = __fmul_rn(a[k].z, inv);
    a[k].w = __fmul_rn(a[k].w, inv);
    const int v = lane + 32 * k;
    if (v >= n4) continue;
    if (norm != nullptr) {
      alignas(8) __nv_bfloat16 h[4] = {
          __float2bfloat16_rn(a[k].x), __float2bfloat16_rn(a[k].y),
          __float2bfloat16_rn(a[k].z), __float2bfloat16_rn(a[k].w)};
      reinterpret_cast<uint2*>(norm + row * d)[v] =
          *reinterpret_cast<const uint2*>(h);
    }
    if (q8 != nullptr) {
      alignas(4) int8_t b[4] = {to_int8(a[k].x), to_int8(a[k].y),
                                to_int8(a[k].z), to_int8(a[k].w)};
      reinterpret_cast<uint32_t*>(q8 + row * d)[v] =
          *reinterpret_cast<const uint32_t*>(b);
    }
  }
  // the prefix sums of xn^2, GROUP dims at a time, from the registers
  for (int g = 0; g < dims.n; g += GROUP) {
    float acc[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = 4 * (lane + 32 * k);
      add_prefix(acc, dims, g, c, __fmul_rn(a[k].x, a[k].x));
      add_prefix(acc, dims, g, c + 1, __fmul_rn(a[k].y, a[k].y));
      add_prefix(acc, dims, g, c + 2, __fmul_rn(a[k].z, a[k].z));
      add_prefix(acc, dims, g, c + 3, __fmul_rn(a[k].w, a[k].w));
    }
    store_prefix(acc, dims, g, lane, inv_out + row * dims.n);
  }
  if (live != nullptr && lane == 0) live[row] = 1;
}

// Any d and alignment: scalar loads in the same element order (lane l
// holds elements 4 (l + 32 k) + 0..3), the row read again for the second
// pass and for each further group of prefix dims.
__global__ void __launch_bounds__(32 * MAX_ROWS_PER_BLOCK)
prep_vectors_any(const float* __restrict__ x, long long n, int d, Dims dims,
              __nv_bfloat16* __restrict__ norm, int8_t* __restrict__ q8,
              float* __restrict__ inv_out, uint8_t* __restrict__ live) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= n) return;
  const float* xr = x + row * d;
  float s = 0.0f;
  for (int c0 = 4 * lane; c0 < d; c0 += 128)
    for (int c = c0; c < c0 + 4 && c < d; ++c) {
      const float a = __ldg(xr + c);
      s = __fadd_rn(s, __fmul_rn(a, a));
    }
  const float inv = inv_norm(warp_sum(s));

  for (int g = 0; g == 0 || g < dims.n; g += GROUP) {
    float acc[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) acc[j] = 0.0f;
    for (int c0 = 4 * lane; c0 < d; c0 += 128)
      for (int c = c0; c < c0 + 4 && c < d; ++c) {
        const float e = __fmul_rn(__ldg(xr + c), inv);
        if (g == 0) {
          if (norm != nullptr) norm[row * d + c] = __float2bfloat16_rn(e);
          if (q8 != nullptr) q8[row * d + c] = to_int8(e);
        }
        add_prefix(acc, dims, g, c, __fmul_rn(e, e));
      }
    store_prefix(acc, dims, g, lane, inv_out + row * dims.n);
  }
  if (live != nullptr && lane == 0) live[row] = 1;
}

template <int NV>
void launch_reg(unsigned blocks, int threads, cudaStream_t st,
                const float* x, long long n, int d, const Dims& dd,
                __nv_bfloat16* norm, int8_t* q8, float* inv, uint8_t* live) {
  prep_vectors_reg<NV><<<blocks, threads, 0, st>>>(x, n, d, dd, norm, q8, inv,
                                                 live);
}

}  // namespace

// x (n, d) f32, contiguous; dims: n_dims host ints (<= 64); norm (n, d)
// bf16, q8 (n, d) int8, inv (n, n_dims) f32 and live (n,) bool, each
// contiguous or NULL (not written). The output pointers address the first
// row to write, so an insert at row `start` passes each plane's row
// `start`. Returns a cudaError_t (0 = launched).
extern "C" int prep_vectors_launch(const float* x, long long n, int d,
                                   const int* dims, int n_dims, void* norm,
                                   int8_t* q8, float* inv, uint8_t* live,
                                   void* stream) {
  if (n <= 0 || d < 0 || n_dims < 0 || n_dims > MAX_DIMS ||
      (n_dims > 0 && (dims == nullptr || inv == nullptr)))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // the fewest rows a block that still give every SM 4 blocks
  int rows = 1;
  while (rows < MAX_ROWS_PER_BLOCK && n / (2 * rows) >= 4LL * sms) rows *= 2;
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  Dims dd;
  dd.n = n_dims;
  for (int j = 0; j < MAX_DIMS; ++j) dd.d[j] = j < n_dims ? dims[j] : 0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(norm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const int threads = 32 * rows;
  const int nv = (d + 127) / 128;
  const bool reg = d % 4 == 0 && nv >= 1 && nv <= MAX_V &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(norm) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(q8) % 4 == 0;
  if (!reg) {
    prep_vectors_any<<<nb, threads, 0, st>>>(x, n, d, dd, out, q8, inv, live);
    return cudaGetLastError();
  }
  switch (nv) {
    case 1: launch_reg<1>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    case 2: launch_reg<2>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    case 3: launch_reg<3>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    case 4: launch_reg<4>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    case 5: launch_reg<5>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    case 6: launch_reg<6>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    case 7: launch_reg<7>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
    default: launch_reg<8>(nb, threads, st, x, n, d, dd, out, q8, inv, live); break;
  }
  return cudaGetLastError();
}
