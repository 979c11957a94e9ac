// Single-query decode attention over a (B, H, L, D) KV cache: int8 dequant,
// per-slot lengths and an optional (B, H, L) bias row, fused.
//
// Replaces the Pallas kernels flasht5_tpu/ops/decode_attention.py::_kernel_flat
// and ::_kernel (one kernel covers both). Each CTA owns one (head, slot) and
// streams that slot's cache once, in chunks of 512 positions, with an fp32
// running max, sum and accumulator. The 512 chunk matches the TPU kernel's,
// so for caches of up to 512 positions the softmax sees the same maximum and
// P is rounded at the same values; the TPU's padding of L to 128 is a layout
// choice that masking replaces here. Positions at or beyond a slot's length
// are never read.
//
// Dequantization as on the TPU: the per-position k scales multiply the
// scores after the q.k product and the v scales fold into P, so the int8
// values enter the products unscaled. The compute type mirrors the TPU
// kernel: q, k, P and v are rounded to bf16 unless q and the cache are both
// f32; all sums are fp32.
//
// Bound on the H100: bytes. One step reads each slot's cache once (int8
// values plus one f32 scale per position and head) and does 4*D operations
// per position. The kernel reads each cache row with 16-byte loads, one row
// per thread for the scores and one coalesced row per warp for P.V.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;
constexpr int kPer = kChunk / kThreads;   // positions per thread per chunk

template <typename T>
struct Vec {  // one 16-byte load of a cache row
  static constexpr int n = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) out[i] = ft5::to_float(e[i]);
}

__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red is free again
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) x = is_max ? fmaxf(x, red[i]) : x + red[i];
  return x;
}

template <typename TQ, typename TKV, bool kBf16, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const float* __restrict__ k_scales,
              const float* __restrict__ v_scales,
              const int* __restrict__ lengths, const float* __restrict__ bias,
              TQ* __restrict__ out, int H, int L, float sm_scale) {
  constexpr int kParts = kThreads / D;   // threads sharing one output column
  __shared__ float qs[D];
  __shared__ float ps[kChunk];
  __shared__ float red[kThreads / 32];
  __shared__ float part_acc[kParts][D];

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const bool quant = k_scales != nullptr;
  auto rnd = [](float x) { return kBf16 ? ft5::round_bf16(x) : x; };

  for (int d = tid; d < D; d += kThreads) qs[d] = rnd(ft5::to_float(q[bh * D + d]));
  const int len = lengths != nullptr ? min(max(lengths[b], 0), L) : L;
  const TKV* kb = k + bh * L * D;
  const TKV* vb = v + bh * L * D;
  const float* ksb = quant ? k_scales + bh * L : nullptr;
  const float* vsb = quant ? v_scales + bh * L : nullptr;
  const float* bb = bias != nullptr ? bias + bh * L : nullptr;
  __syncthreads();

  const int dcol = tid % D, part = tid / D;
  float acc = 0.f, m_i = ft5::kNegInf, l_i = 0.f;

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    float s[kPer];
    float mt = ft5::kNegInf;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = c0 + tid + i * kThreads;
      s[i] = ft5::kNegInf;
      if (j < len) {
        const TKV* krow = kb + static_cast<size_t>(j) * D;
        float dot = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < D; d0 += Vec<TKV>::n) {
          float kv[Vec<TKV>::n];
          load16(krow + d0, kv);
#pragma unroll
          for (int t = 0; t < Vec<TKV>::n; ++t) dot += qs[d0 + t] * rnd(kv[t]);
        }
        if (quant) dot *= ksb[j];
        dot *= sm_scale;
        if (bb != nullptr) dot += bb[j];
        s[i] = dot;
      }
      mt = fmaxf(mt, s[i]);
    }
    mt = block_reduce(mt, red, true);
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = c0 + tid + i * kThreads;
      float p = 0.f, pv = 0.f;
      if (j < len) {
        p = expf(s[i] - m_new);
        pv = rnd(quant ? p * vsb[j] : p);
      }
      psum += p;
      ps[tid + i * kThreads] = pv;
    }
    psum = block_reduce(psum, red, false);   // also orders the ps writes
    l_i = l_i * alpha + psum;
    m_i = m_new;
    acc *= alpha;
    const int n = min(kChunk, len - c0);
    for (int jj = part; jj < n; jj += kParts)
      acc += ps[jj] * rnd(ft5::to_float(vb[static_cast<size_t>(c0 + jj) * D + dcol]));
    __syncthreads();  // ps is read before the next chunk rewrites it
  }

  part_acc[part][dcol] = acc;
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) total += part_acc[p][tid];
    const float l_safe = l_i > 0.f ? l_i : 1.f;
    out[bh * D + tid] = ft5::from_float<TQ>(total / l_safe);
  }
}

template <typename TQ, typename TKV, bool kBf16>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* lengths,
                     const float* bias, void* out, int B, int H, int L,
                     float sm_scale, cudaStream_t stream) {
  dim3 grid(H, B);
#define FT5_DECODE_CASE(DD)                                                   \
  case DD:                                                                    \
    decode_kernel<TQ, TKV, kBf16, DD><<<grid, kThreads, 0, stream>>>(         \
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),                \
        static_cast<const TKV*>(v), ks, vs, lengths, bias,                    \
        static_cast<TQ*>(out), H, L, sm_scale);                               \
    break;
  switch (D) {
    FT5_DECODE_CASE(32)
    FT5_DECODE_CASE(64)
    FT5_DECODE_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FT5_DECODE_CASE
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, int D, const void* q, const void* k,
                      const void* v, const float* ks, const float* vs,
                      const int* lengths, const float* bias, void* out, int B,
                      int H, int L, float sm_scale, cudaStream_t stream) {
  constexpr bool q32 = sizeof(TQ) == 4;
  switch (kv_dtype) {
    case ft5::kFloat32:
      return launch_d<TQ, float, !q32>(D, q, k, v, ks, vs, lengths, bias, out,
                                       B, H, L, sm_scale, stream);
    case ft5::kBFloat16:
      return launch_d<TQ, __nv_bfloat16, true>(D, q, k, v, ks, vs, lengths,
                                               bias, out, B, H, L, sm_scale,
                                               stream);
    case 2:  // int8 with scales
      return launch_d<TQ, int8_t, true>(D, q, k, v, ks, vs, lengths, bias, out,
                                        B, H, L, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D) and out (B,H,D) in `q_dtype`; k/v (B,H,L,D) in `kv_dtype`
// (0 f32, 1 bf16, 2 int8 with k_scales/v_scales (B,H,L) f32); lengths (B,)
// int32 or null; bias (B,H,L) f32 or null. All contiguous, rows 16-byte
// aligned.
FT5_EXPORT int ft5_decode_attention(const void* q, const void* k,
                                    const void* v, const float* k_scales,
                                    const float* v_scales, const int* lengths,
                                    const float* bias, void* out, int B, int H,
                                    int L, int D, float sm_scale, int q_dtype,
                                    int kv_dtype, void* stream) {
  if ((kv_dtype == 2) != (k_scales != nullptr) || L <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == ft5::kFloat32)
    return launch_kv<float>(kv_dtype, D, q, k, v, k_scales, v_scales, lengths,
                            bias, out, B, H, L, sm_scale, s);
  if (q_dtype == ft5::kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, D, q, k, v, k_scales, v_scales,
                                    lengths, bias, out, B, H, L, sm_scale, s);
  return cudaErrorInvalidValue;
}
