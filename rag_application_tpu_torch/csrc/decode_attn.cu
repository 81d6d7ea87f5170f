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
// What this design does about it: flash-decoding. The S axis is cut into
// chunks of `chunk` slots; one 128-thread block owns one (chunk, kv head,
// row) triple, so the grid has B*KVH*ceil(S/chunk) blocks and a B = 1 call
// still spreads over the card. A block stages its chunk's K and V rows in
// shared memory with 16-byte loads (a slot's hd bytes are contiguous, and a
// warp's loads cover whole 32-byte sectors), at a row pitch of hd/4+1 words
// so that the score loop's 32 lanes (32 slots of one query head) read 32
// different banks. Scores, the chunk's max and sum, and the bf16-rounded
// p*v_scale stay in shared memory; each thread then accumulates 4 output
// columns of one query head over the chunk. With more than one chunk the
// blocks write (max, sum, acc) partials and a second kernel merges them;
// with one chunk the first kernel writes the output itself. Every slot is
// read, masked or not, as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG = -1.0e30f;
constexpr size_t SMEM_MAX = 48 * 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one block, in 4-byte words.
__host__ __device__ inline size_t smem_words(int g, int hd, int chunk) {
  const size_t rw = hd / 4 + 1;  // padded K/V row pitch
  return static_cast<size_t>(g) * hd          // q as f32
         + static_cast<size_t>(g) * (chunk + 1)  // scores, then bf16(p*vs)
         + 2 * static_cast<size_t>(g)            // (max, sum) per head
         + 2 * chunk * rw;                       // K and V rows
}

// grid (n_split, KVH, B). part: (B, KVH, n_split, G, hd + 2) f32 partials
// [max, sum, acc...], unused when n_split == 1 (out written directly).
__global__ void __launch_bounds__(THREADS)
decode_attn_split(const __nv_bfloat16* __restrict__ q,
                  const int8_t* __restrict__ k8,
                  const float* __restrict__ ks,
                  const int8_t* __restrict__ v8,
                  const float* __restrict__ vs,
                  const uint8_t* __restrict__ mask, int S, int KVH, int G,
                  int hd, int chunk, float inv_sqrt_hd,
                  float* __restrict__ part, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int s0 = j * chunk;
  const int n = min(chunk, S - s0);  // a multiple of 32
  const int hw = hd / 4;
  const int rw = hw + 1;
  const int ps_pitch = chunk + 1;
  float* qs = smem;
  float* ps = qs + G * hd;
  float* stat = ps + G * ps_pitch;
  int* kw = reinterpret_cast<int*>(stat + 2 * G);
  int* vw = kw + chunk * rw;

  const long long row = static_cast<long long>(KVH) * hd;  // slot pitch
  const long long base = (static_cast<long long>(b) * S + s0) * row +
                         static_cast<long long>(kvh) * hd;
  const int per_row = hd / 16;
  for (int i = threadIdx.x; i < n * per_row; i += THREADS) {
    const int s = i / per_row, c = i - s * per_row;
    const long long off = base + s * row + c * 16;
    const int4 kx = *reinterpret_cast<const int4*>(k8 + off);
    const int4 vx = *reinterpret_cast<const int4*>(v8 + off);
    int* kd = kw + s * rw + c * 4;
    int* vd = vw + s * rw + c * 4;
    kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
    vd[0] = vx.x; vd[1] = vx.y; vd[2] = vx.z; vd[3] = vx.w;
  }
  const __nv_bfloat16* qb =
      q + (static_cast<long long>(b) * KVH + kvh) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS)
    qs[i] = __bfloat162float(qb[i]);
  __syncthreads();

  // scores: lanes of a warp take 32 consecutive slots of one query head
  const long long srow = static_cast<long long>(b) * S + s0;
  for (int i = threadIdx.x; i < G * n; i += THREADS) {
    const int g = i / n, s = i - g * n;
    const float* qg = qs + g * hd;
    const int* kr = kw + s * rw;
    float acc = 0.0f;
    for (int w = 0; w < hw; ++w) {
      const char4 c = *reinterpret_cast<const char4*>(kr + w);
      acc = fmaf(qg[4 * w + 0], static_cast<float>(c.x), acc);
      acc = fmaf(qg[4 * w + 1], static_cast<float>(c.y), acc);
      acc = fmaf(qg[4 * w + 2], static_cast<float>(c.z), acc);
      acc = fmaf(qg[4 * w + 3], static_cast<float>(c.w), acc);
    }
    const float sc = (acc * ks[(srow + s) * KVH + kvh]) * inv_sqrt_hd;
    ps[g * ps_pitch + s] = mask[srow + s] ? sc : NEG;
  }
  __syncthreads();

  // chunk softmax, one warp per query head: the vis factor keeps a fully
  // masked chunk (m = NEG, exp(0) = 1) at p = 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* pg = ps + g * ps_pitch;
    float m = NEG;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, pg[s]);
    m = warp_max(m);
    float l = 0.0f;
    for (int s = lane; s < n; s += 32) {
      const float vis = mask[srow + s] ? 1.0f : 0.0f;
      const float p = expf(pg[s] - m) * vis;
      l += p;
      pg[s] = __bfloat162float(
          __float2bfloat16_rn(p * vs[(srow + s) * KVH + kvh]));
    }
    l = warp_sum(l);
    if (lane == 0) {
      stat[2 * g] = m;
      stat[2 * g + 1] = l;
    }
  }
  __syncthreads();

  // p @ V: thread owns 4 output columns of one query head
  for (int qd = threadIdx.x; qd < G * hw; qd += THREADS) {
    const int g = qd / hw, w = qd - g * hw;
    const float* pg = ps + g * ps_pitch;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    for (int s = 0; s < n; ++s) {
      const float p = pg[s];
      const char4 c = *reinterpret_cast<const char4*>(vw + s * rw + w);
      a0 = fmaf(p, static_cast<float>(c.x), a0);
      a1 = fmaf(p, static_cast<float>(c.y), a1);
      a2 = fmaf(p, static_cast<float>(c.z), a2);
      a3 = fmaf(p, static_cast<float>(c.w), a3);
    }
    const long long head = (static_cast<long long>(b) * KVH + kvh) * G + g;
    if (n_split == 1) {
      const float l = fmaxf(stat[2 * g + 1], 1e-30f);
      __nv_bfloat16* o = out + head * hd + 4 * w;
      o[0] = __float2bfloat16_rn(a0 / l);
      o[1] = __float2bfloat16_rn(a1 / l);
      o[2] = __float2bfloat16_rn(a2 / l);
      o[3] = __float2bfloat16_rn(a3 / l);
    } else {
      const long long bk = static_cast<long long>(b) * KVH + kvh;
      float* pp = part + ((bk * n_split + j) * G + g) * (hd + 2);
      if (w == 0) {
        pp[0] = stat[2 * g];
        pp[1] = stat[2 * g + 1];
      }
      pp[2 + 4 * w + 0] = a0;
      pp[2 + 4 * w + 1] = a1;
      pp[2 + 4 * w + 2] = a2;
      pp[2 + 4 * w + 3] = a3;
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

}  // namespace

// q (B, KVH, G, hd) bf16; k8/v8 (B, S, KVH, hd) int8, 16-byte aligned;
// ks/vs (B, S, KVH) f32; mask (B, S) bool; all contiguous. S and chunk are
// multiples of 32, hd a multiple of 16 (<= 1024). part: B*KVH*n_split*G*
// (hd+2) f32 scratch with n_split = ceil(S/chunk), may be NULL when
// n_split == 1. out (B, KVH, G, hd) bf16. Returns a cudaError_t (0 = both
// kernels launched).
extern "C" int decode_attn_launch(const void* q, const int8_t* k8,
                                  const float* ks, const int8_t* v8,
                                  const float* vs, const uint8_t* mask,
                                  int B, int S, int KVH, int G, int hd,
                                  int chunk, float inv_sqrt_hd, float* part,
                                  void* out, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || G <= 0 || hd <= 0 || hd % 16 ||
      hd > 1024 || S % 32 || chunk <= 0 || chunk % 32 || B > 65535 ||
      KVH > 65535)
    return cudaErrorInvalidValue;
  const int n_split = (S + chunk - 1) / chunk;
  if (n_split > 1 && part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_words(G, hd, chunk) * 4;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_attn_split<<<dim3(n_split, KVH, B), THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), k8, ks, v8, vs, mask, S, KVH, G,
      hd, chunk, inv_sqrt_hd, part, static_cast<__nv_bfloat16*>(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const long long heads = static_cast<long long>(B) * KVH * G;
  if (heads > 2147483647LL) return cudaErrorInvalidValue;
  decode_attn_combine<<<static_cast<unsigned>(heads), hd, 0, st>>>(
      part, n_split, G, hd, static_cast<__nv_bfloat16*>(out));
  return cudaGetLastError();
}
