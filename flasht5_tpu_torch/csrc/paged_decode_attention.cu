// Paged single-query decode attention: each slot's K/V live in pages of a
// shared pool, found through the slot's row of a page table.
//
// Replaces the three Pallas kernels of flasht5_tpu/inference/paged_kv.py:
// _paged_kernel (a (slot, page) grid), _ragged_kernel (a work list of live
// pages) and _chunked_kernel (a work list of page runs over fused K/V
// records, returning the softmax state (m, l) for an LSE merge). All three
// compute one function; their grids and work lists order the TPU's
// sequential grid and feed its DMA engine, which a GPU does not need: here
// one CTA owns one (head, slot), reads the slot's page ids from the table
// itself and walks its pages j < ceil(len / P) in chunks of kChunk
// positions, with an fp32 running max, sum and accumulator. Positions at or
// beyond the slot's length are never read. The page, plane and head strides
// are arguments, so the kernel reads the standard pair of pools
// (N, H, P, D) and the two planes of the fused record (N, 2, H, P, D) alike.
//
// Arithmetic as in _chunked_kernel: the per-token int8 scales multiply the
// scores after the q.k product (k) and fold into P before P.V (v), so the
// int8 values enter the products unscaled. int8 pools and f32 q over an f32
// pool compute in fp32; otherwise q, k, P and v are rounded to bf16, as the
// TPU kernels do for bf16 pools. All sums are fp32. A slot of length 0
// gives out 0, m = -1e30 and l = 0, the TPU kernels' empty-slot state.
//
// Bound on the H100: bytes. One call reads each live token's K and V row
// once (plus one f32 scale each when int8) and does 4*D operations per token
// and head. Each row is read with 16-byte loads by D / (16 / sizeof(T))
// neighbouring threads, so a warp reads whole rows; the score of a row is a
// shuffle sum within its threads.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 256;   // positions whose scores a CTA holds at once

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int n = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < n; ++i) out[i] = ft5::to_float(e[i]);
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

struct Layout {
  long long page, head;        // value strides, in elements
  long long s_page, s_head;    // scale strides, in elements
};

template <typename TQ, typename TKV, bool kBf16, int D>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const float* __restrict__ ks,
             const float* __restrict__ vs, const int* __restrict__ page_table,
             const int* __restrict__ lengths, const float* __restrict__ bias,
             TQ* __restrict__ out, float* __restrict__ m_out,
             float* __restrict__ l_out, int H, int P, int maxp, Layout lay,
             float sm_scale) {
  constexpr int kVec = 16 / sizeof(TKV);      // elements per 16-byte load
  constexpr int kTpr = D / kVec;              // threads per row
  constexpr int kRows = kThreads / kTpr;      // rows per pass
  static_assert(kTpr >= 1 && kTpr <= 32 && (kTpr & (kTpr - 1)) == 0, "row split");
  __shared__ float ps[kChunk];
  __shared__ float red[kThreads / 32];
  __shared__ float part[kRows][D];

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int grp = tid / kTpr, d0 = (tid % kTpr) * kVec;
  const bool quant = ks != nullptr;
  auto rnd = [](float x) { return kBf16 ? ft5::round_bf16(x) : x; };

  float qv[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qv[e] = rnd(ft5::to_float(q[bh * D + d0 + e]));
  const int len = min(max(lengths[b], 0), maxp * P);
  const int* pt = page_table + static_cast<size_t>(b) * maxp;
  const float* bb = bias != nullptr ? bias + bh * maxp * P : nullptr;
  // element offsets of token `pos` of head h: values and scales
  auto where = [&](int pos, long long& row, long long& srow) {
    const int j = pos / P, off = pos - j * P;
    const long long pid = pt[j];
    row = pid * lay.page + h * lay.head + static_cast<long long>(off) * D;
    srow = pid * lay.s_page + h * lay.s_head + off;
  };

  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  float m_i = ft5::kNegInf, l_i = 0.f;

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int n = min(kChunk, len - c0);
    // scores: kTpr threads per row, a shuffle sum within them (the loop
    // bound is the same for the whole block, so every lane shuffles)
    for (int r0 = 0; r0 < n; r0 += kRows) {
      const int r = r0 + grp;
      long long row = 0, srow = 0;
      float dot = 0.f;
      if (r < n) {
        where(c0 + r, row, srow);
        float kv[kVec];
        load16(k + row + d0, kv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot += qv[e] * rnd(kv[e]);
      }
#pragma unroll
      for (int o = kTpr / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (r < n && d0 == 0) {
        if (quant) dot *= ks[srow];
        dot *= sm_scale;
        if (bb != nullptr) dot += bb[c0 + r];
        ps[r] = dot;
      }
    }
    __syncthreads();
    float mt = ft5::kNegInf;
    for (int r = tid; r < n; r += kThreads) mt = fmaxf(mt, ps[r]);
    mt = block_reduce(mt, red, true);
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
    for (int r = tid; r < n; r += kThreads) {
      const float p = expf(ps[r] - m_new);
      psum += p;
      ps[r] = p;
    }
    psum = block_reduce(psum, red, false);   // also orders the ps writes
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= alpha;
    for (int r = grp; r < n; r += kRows) {
      long long row, srow;
      where(c0 + r, row, srow);
      const float p = rnd(quant ? ps[r] * vs[srow] : ps[r]);
      float vv[kVec];
      load16(v + row + d0, vv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] += p * rnd(vv[e]);
    }
    __syncthreads();  // ps is read before the next chunk rewrites it
  }

#pragma unroll
  for (int e = 0; e < kVec; ++e) part[grp][d0 + e] = acc[e];
  __syncthreads();
  if (tid < D) {
    float total = 0.f;
#pragma unroll 4
    for (int g = 0; g < kRows; ++g) total += part[g][tid];
    const float l_safe = l_i > 0.f ? l_i : 1.f;
    out[bh * D + tid] = ft5::from_float<TQ>(total / l_safe);
  }
  if (tid == 0 && m_out != nullptr) {
    m_out[bh] = l_i > 0.f ? m_i : ft5::kNegInf;
    l_out[bh] = l_i;
  }
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *page_table, *lengths;
  const float* bias;
  void* out;
  float *m_out, *l_out;
  int B, H, P, maxp;
  Layout lay;
  float sm_scale;
};

template <typename TQ, typename TKV, bool kBf16>
cudaError_t launch_d(int D, const Args& a, cudaStream_t stream) {
  dim3 grid(a.H, a.B);
#define FT5_PAGED_CASE(DD)                                                    \
  case DD:                                                                    \
    paged_kernel<TQ, TKV, kBf16, DD><<<grid, kThreads, 0, stream>>>(          \
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),            \
        static_cast<const TKV*>(a.v), a.ks, a.vs, a.page_table, a.lengths,    \
        a.bias, static_cast<TQ*>(a.out), a.m_out, a.l_out, a.H, a.P, a.maxp,  \
        a.lay, a.sm_scale);                                                   \
    break;
  switch (D) {
    FT5_PAGED_CASE(32)
    FT5_PAGED_CASE(64)
    FT5_PAGED_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FT5_PAGED_CASE
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, int D, const Args& a, cudaStream_t s) {
  constexpr bool q32 = sizeof(TQ) == 4;
  switch (kv_dtype) {
    case ft5::kFloat32: return launch_d<TQ, float, !q32>(D, a, s);
    case ft5::kBFloat16: return launch_d<TQ, __nv_bfloat16, true>(D, a, s);
    case 2: return launch_d<TQ, int8_t, false>(D, a, s);   // int8 + scales: fp32
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D) and out (B,H,D) in `q_dtype` (0 f32, 1 bf16); K/V token rows of
// D contiguous `kv_dtype` elements (0 f32, 1 bf16, 2 int8 with f32 scales
// ks/vs) at element offset pid*page_stride + h*head_stride + off*D from k
// and v, their scales at pid*s_page_stride + h*s_head_stride + off from ks
// and vs; page_table (B, maxp) and lengths (B,) int32; bias (B, H, maxp*P)
// f32 or null; m_out and l_out (B, H) f32, both or neither. Rows 16-byte
// aligned.
FT5_EXPORT int ft5_paged_decode_attention(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* page_table, const int* lengths,
    const float* bias, void* out, float* m_out, float* l_out, int B, int H,
    int D, int P, int maxp, long long page_stride, long long head_stride,
    long long s_page_stride, long long s_head_stride, float sm_scale,
    int q_dtype, int kv_dtype, void* stream) {
  if ((kv_dtype == 2) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr) ||
      (m_out == nullptr) != (l_out == nullptr) || B <= 0 || H <= 0 || P <= 0 ||
      maxp <= 0 || page_table == nullptr || lengths == nullptr)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, ks, vs, page_table, lengths, bias, out, m_out, l_out,
               B, H, P, maxp,
               Layout{page_stride, head_stride, s_page_stride, s_head_stride},
               sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == ft5::kFloat32) return launch_kv<float>(kv_dtype, D, a, s);
  if (q_dtype == ft5::kBFloat16) return launch_kv<__nv_bfloat16>(kv_dtype, D, a, s);
  return cudaErrorInvalidValue;
}
