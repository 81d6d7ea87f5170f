// Insert-time prep pass for Hopper (sm_90a): one read of an insert batch
// gives every derived view the dense index stores.
//
// Replaces: rag_application_tpu/ops/quant.py::_prep_kernel (the Pallas TPU
// kernel launched by prepare_vectors). For every row x of the (N, d) f32
// batch it computes, in f32,
//   inv    = rsqrt(max(sum_c x[c]^2, 1e-12)),   xn = x * inv
//   norm   = bf16(xn)                            (round to nearest even)
//   int8   = clip(rint(xn * 127), -127, 127)     (round half to even)
//   inv_j  = rsqrt(max(sum_{c < dims[j]} xn[c]^2, 1e-12))  for each j
// The prefix sums take the squares of the NORMALIZED row, as the reference
// does. A zero row gives inv = 1e6, zeros and inv_j = 1e6. The Pallas
// wrapper pads the batch to its row block with 1.0; here every row is real
// and nothing is padded.
//
// What bounds it on the H100: bytes. A row reads 4d bytes and writes
// 2d (bf16) + d (int8) + 4M bytes; at a 131,072 x 768 slab with M = 3 that
// is 706 MB, 0.211 ms at 3.35 TB/s. The arithmetic is a few flops per
// element.
//
// What this design does about it: one warp per row, 8 rows per 256-thread
// block, so a row's sums close with warp shuffles and no shared memory or
// block barrier. When d is a multiple of 4 every lane moves 16-byte vectors
// (float4 in, 8-byte bf16x4 and 4-byte int8x4 out), neighbouring lanes on
// neighbouring addresses. The first pass sums x^2; the second reads the row
// again (it is 3 KB at d = 768, still in L1) to normalize, store, and sum
// xn^2 into one register per prefix dim; the prefix dims are taken in
// groups of 8 registers, so any count of them works (one group for the
// repo's three).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr int GROUP = 8;      // prefix-dim accumulators held per pass
constexpr int MAX_DIMS = 64;  // prefix dims per launch

struct Dims {
  int n;
  int d[MAX_DIMS];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int8_t to_int8(float xn) {
  const float r = fminf(fmaxf(rintf(xn * 127.0f), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// Adds xn^2 to the accumulators of the prefix dims [g, g + GROUP) that
// element c lies in.
__device__ __forceinline__ void add_prefix(float (&acc)[GROUP],
                                           const Dims& dims, int g, int c,
                                           float sq) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j)
    if (g + j < dims.n && c < dims.d[g + j]) acc[j] += sq;
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
prep_vectors_kernel(const float* __restrict__ x, long long n, int d,
                    Dims dims, __nv_bfloat16* __restrict__ norm,
                    int8_t* __restrict__ q8, float* __restrict__ inv_out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together
  const float* xr = x + row * d;
  __nv_bfloat16* nr = norm + row * d;
  int8_t* qr = q8 + row * d;

  // pass 1: the row's sum of squares
  float s = 0.0f;
  if (VEC4) {
    const float4* xv = reinterpret_cast<const float4*>(xr);
    for (int v = lane; v < d / 4; v += 32) {
      const float4 a = __ldg(xv + v);
      s += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float a = __ldg(xr + c);
      s += a * a;
    }
  }
  const float inv = rsqrtf(fmaxf(warp_sum(s), 1e-12f));

  // pass 2: normalize, store both planes, and the prefix sums of xn^2 for
  // the first GROUP dims (later groups re-read the row; none in practice)
  for (int g = 0; g == 0 || g < dims.n; g += GROUP) {
    float acc[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) acc[j] = 0.0f;
    const bool store = g == 0;
    if (VEC4) {
      const float4* xv = reinterpret_cast<const float4*>(xr);
      for (int v = lane; v < d / 4; v += 32) {
        const float4 a = __ldg(xv + v);
        const float e[4] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv};
        if (store) {
          alignas(8) __nv_bfloat16 h[4];
          alignas(4) int8_t b[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            h[t] = __float2bfloat16_rn(e[t]);
            b[t] = to_int8(e[t]);
          }
          reinterpret_cast<uint2*>(nr)[v] = *reinterpret_cast<const uint2*>(h);
          reinterpret_cast<uint32_t*>(qr)[v] =
              *reinterpret_cast<const uint32_t*>(b);
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) add_prefix(acc, dims, g, 4 * v + t,
                                                e[t] * e[t]);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float e = __ldg(xr + c) * inv;
        if (store) {
          nr[c] = __float2bfloat16_rn(e);
          qr[c] = to_int8(e);
        }
        add_prefix(acc, dims, g, c, e * e);
      }
    }
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const float t = warp_sum(acc[j]);
      if (lane == 0 && g + j < dims.n)
        inv_out[row * dims.n + g + j] = rsqrtf(fmaxf(t, 1e-12f));
    }
  }
}

}  // namespace

// x (n, d) f32; dims: n_dims host ints (<= 64); norm (n, d) bf16, q8 (n, d)
// int8 and inv (n, n_dims) f32; all contiguous. Returns a cudaError_t
// (0 = launched).
extern "C" int prep_vectors_launch(const float* x, long long n, int d,
                                   const int* dims, int n_dims, void* norm,
                                   int8_t* q8, float* inv, void* stream) {
  if (n <= 0 || d < 0 || n_dims < 0 || n_dims > MAX_DIMS ||
      (n_dims > 0 && (dims == nullptr || inv == nullptr)))
    return cudaErrorInvalidValue;
  const long long blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  Dims dd;
  dd.n = n_dims;
  for (int j = 0; j < MAX_DIMS; ++j) dd.d[j] = j < n_dims ? dims[j] : 0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(norm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(norm) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(q8) % 4 == 0;
  if (vec4)
    prep_vectors_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                                st>>>(x, n, d, dd, out, q8, inv);
  else
    prep_vectors_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 st>>>(x, n, d, dd, out, q8, inv);
  return cudaGetLastError();
}
