// Single-query decode attention over a (B, H, L, D) KV cache: int8 dequant,
// per-slot lengths and an optional (B, H, L) bias row, fused.
//
// Replaces the Pallas kernels flasht5_tpu/ops/decode_attention.py::_kernel_flat
// and ::_kernel (one kernel covers both). The design is single_query.cuh's:
// a (head, slot)'s positions are cut into units of `unit` positions, one a
// warp, over `warps` warps a CTA and a cluster of `splits` CTAs (the plan of
// ops/decode_attention.py::decode_plan, from shapes alone); each warp puts
// its share of K, V and scales in flight at once through cp.async and the
// partial states meet in a fixed order through distributed shared memory.
// A (slot, head)'s cache is one "page" of L positions here, so the page id of
// slot b is b itself. Positions at or beyond a slot's length are never read,
// and a CTA whose share lies beyond it reads nothing.
//
// Rounding points as on the TPU: for caches of up to 512 positions (the TPU
// kernel's chunk) every score is formed first and the cluster agrees on the
// cache's maximum before any P is rounded, as the TPU kernel and
// decode_attention_plain do; longer caches run an online softmax a warp. The
// per-position k scales multiply the scores after the q.k product and the v
// scales fold into P, so the int8 values enter the products unscaled. q, k,
// P and v are rounded to bf16 unless q and the cache are both f32 (int8
// values are bf16-exact); all sums are fp32.
//
// Bound on the H100: bytes. One step reads each slot's live cache once (int8
// values plus one f32 scale per position and head) and does 4*D operations
// per position.

#include <algorithm>

#include "single_query.cuh"

namespace {

template <typename TQ, typename TKV, bool kBf16, int D>
__global__ void __launch_bounds__(ft5::sq::kMaxWarps * 32)
decode_attn_kernel(const ft5::sq::Params p) {
  extern __shared__ float4 smem4[];
  ft5::sq::attend<TQ, TKV, kBf16, D>(p, reinterpret_cast<char*>(smem4));
}

constexpr int kExactMax = 512;   // the TPU kernel's chunk of positions

template <typename TQ, typename TKV, bool kBf16>
cudaError_t launch_d(ft5::sq::Params p, int B, int L, int splits, int warps,
                     cudaStream_t stream) {
  const int row_bytes = p.D * static_cast<int>(sizeof(TKV));
  p.span = p.page = L;
  p.maxp = 1;
  p.head_stride = static_cast<long long>(L) * p.D;
  p.page_stride = p.head_stride * p.H;
  p.s_head_stride = L;
  p.s_page_stride = static_cast<long long>(L) * p.H;
  p.rows = std::min(ft5::sq::max_rows(row_bytes), p.unit);
  p.exact = L <= kExactMax;
  p.sc_len = p.exact ? p.unit : p.rows;
  p.ids = 0;
#define FT5_DECODE_CASE(DD)                                                   \
  case DD: {                                                                  \
    static unsigned set = 0;                                                  \
    return ft5::sq::launch(decode_attn_kernel<TQ, TKV, kBf16, DD>, set, p,    \
                           row_bytes, B, splits, warps, stream);              \
  }
  switch (p.D) {
    FT5_DECODE_CASE(32)
    FT5_DECODE_CASE(64)
    FT5_DECODE_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FT5_DECODE_CASE
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const ft5::sq::Params& p, int B, int L,
                      int splits, int warps, cudaStream_t s) {
  constexpr bool q32 = sizeof(TQ) == 4;
  switch (kv_dtype) {
    case ft5::kFloat32:
      return launch_d<TQ, float, !q32>(p, B, L, splits, warps, s);
    case ft5::kBFloat16:
      return launch_d<TQ, __nv_bfloat16, true>(p, B, L, splits, warps, s);
    case 2:  // int8 with scales: the bf16 route, as on the TPU
      return launch_d<TQ, int8_t, true>(p, B, L, splits, warps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D) and out (B,H,D) in `q_dtype`; k/v (B,H,L,D) in `kv_dtype`
// (0 f32, 1 bf16, 2 int8 with k_scales/v_scales (B,H,L) f32); lengths (B,)
// int32 or null; bias (B,H,L) f32 or null. All contiguous, rows 16-byte
// aligned. The plan (ops/decode_attention.py::decode_plan): clusters of
// `splits` CTAs of `warps` warps, `unit` positions a warp, splits * warps *
// unit >= L.
FT5_EXPORT int ft5_decode_attention(const void* q, const void* k,
                                    const void* v, const float* k_scales,
                                    const float* v_scales, const int* lengths,
                                    const float* bias, void* out, int B, int H,
                                    int L, int D, float sm_scale, int q_dtype,
                                    int kv_dtype, int splits, int warps,
                                    int unit, void* stream) {
  if ((kv_dtype == 2) != (k_scales != nullptr) || L <= 0 || B <= 0 ||
      H <= 0 || unit <= 0 ||
      static_cast<long long>(splits) * warps * unit < L)
    return cudaErrorInvalidValue;
  ft5::sq::Params p{};
  p.q = q, p.k = k, p.v = v, p.ks = k_scales, p.vs = v_scales;
  p.table = nullptr, p.lengths = lengths, p.bias = bias, p.out = out;
  p.m_out = p.l_out = nullptr;
  p.H = H, p.D = D, p.sm_scale = sm_scale, p.unit = unit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == ft5::kFloat32)
    return launch_kv<float>(kv_dtype, p, B, L, splits, warps, s);
  if (q_dtype == ft5::kBFloat16)
    return launch_kv<__nv_bfloat16>(kv_dtype, p, B, L, splits, warps, s);
  return cudaErrorInvalidValue;
}
