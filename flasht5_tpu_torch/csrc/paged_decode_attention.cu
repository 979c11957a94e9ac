// Paged single-query decode attention: each slot's K/V live in pages of a
// shared pool, found through the slot's row of a page table.
//
// Replaces the three Pallas kernels of flasht5_tpu/inference/paged_kv.py:
// _paged_kernel (a (slot, page) grid), _ragged_kernel (a work list of live
// pages) and _chunked_kernel (a work list of page runs over fused K/V
// records, returning the softmax state (m, l) for an LSE merge). All three
// compute one function; their grids and work lists order the TPU's
// sequential grid and feed its DMA engine, which a GPU does not need. The
// design is single_query.cuh's: a (head, slot)'s pages are cut into units of
// whole pages, one a warp, over `warps` warps a CTA and a cluster of `splits`
// CTAs (the plan of ops/paged_attention.py::paged_plan, from shapes alone). Each warp reads its pages' ids from the table once, then puts the
// K, V and scale runs of those pages in flight through a ring of bulk-copy
// items (a page's plane of one head is one contiguous run of P rows), runs
// an online softmax over them in registers, and the warps' and CTAs' states
// merge in a fixed order through shared and distributed shared memory.
// Positions at or beyond a slot's length are never read. The page, plane and
// head strides are arguments, so the kernel reads the standard pair of pools
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
// and head.

#include <algorithm>

#include "single_query.cuh"

namespace {

template <typename TQ, typename TKV, bool kBf16, int D>
__global__ void __launch_bounds__(ft5::sq::kMaxWarps * 32)
paged_attn_kernel(const ft5::sq::Params p) {
  extern __shared__ float4 smem4[];
  ft5::sq::attend<TQ, TKV, kBf16, D>(p, reinterpret_cast<char*>(smem4));
}

template <typename TQ, typename TKV, bool kBf16>
cudaError_t launch_d(ft5::sq::Params p, int B, int splits, int warps,
                     cudaStream_t stream) {
  const int row_bytes = p.D * static_cast<int>(sizeof(TKV));
  p.rows = std::min(ft5::sq::max_rows(row_bytes), p.page);
  p.sc_len = p.rows;
  p.exact = 0;
#define FT5_PAGED_CASE(DD)                                                    \
  case DD: {                                                                  \
    static unsigned set = 0;                                                  \
    return ft5::sq::launch(paged_attn_kernel<TQ, TKV, kBf16, DD>, set, p,     \
                           row_bytes, B, splits, warps, stream);              \
  }
  switch (p.D) {
    FT5_PAGED_CASE(32)
    FT5_PAGED_CASE(64)
    FT5_PAGED_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FT5_PAGED_CASE
}

template <typename TQ>
cudaError_t launch_kv(int kv_dtype, const ft5::sq::Params& p, int B,
                      int splits, int warps, cudaStream_t s) {
  constexpr bool q32 = sizeof(TQ) == 4;
  switch (kv_dtype) {
    case ft5::kFloat32:
      return launch_d<TQ, float, !q32>(p, B, splits, warps, s);
    case ft5::kBFloat16:
      return launch_d<TQ, __nv_bfloat16, true>(p, B, splits, warps, s);
    case 2:  // int8 + scales: fp32
      return launch_d<TQ, int8_t, false>(p, B, splits, warps, s);
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
// aligned. The plan (ops/paged_attention.py::paged_plan): clusters of
// `splits` CTAs of `warps` warps, `pages` pages a warp, splits * warps *
// pages >= maxp.
FT5_EXPORT int ft5_paged_decode_attention(
    const void* q, const void* k, const void* v, const float* ks,
    const float* vs, const int* page_table, const int* lengths,
    const float* bias, void* out, float* m_out, float* l_out, int B, int H,
    int D, int P, int maxp, long long page_stride, long long head_stride,
    long long s_page_stride, long long s_head_stride, float sm_scale,
    int q_dtype, int kv_dtype, int splits, int warps, int pages,
    void* stream) {
  if ((kv_dtype == 2) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr) ||
      (m_out == nullptr) != (l_out == nullptr) || B <= 0 || H <= 0 || P <= 0 ||
      maxp <= 0 || page_table == nullptr || lengths == nullptr || pages <= 0 ||
      static_cast<long long>(splits) * warps * pages < maxp ||
      static_cast<long long>(maxp) * P > (1 << 30))
    return cudaErrorInvalidValue;
  ft5::sq::Params p{};
  p.q = q, p.k = k, p.v = v, p.ks = ks, p.vs = vs;
  p.table = page_table, p.lengths = lengths, p.bias = bias, p.out = out;
  p.m_out = m_out, p.l_out = l_out;
  p.H = H, p.D = D, p.span = maxp * P, p.page = P, p.maxp = maxp;
  p.page_stride = page_stride, p.head_stride = head_stride;
  p.s_page_stride = s_page_stride, p.s_head_stride = s_head_stride;
  p.sm_scale = sm_scale, p.unit = pages * P, p.ids = pages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == ft5::kFloat32) return launch_kv<float>(kv_dtype, p, B, splits, warps, s);
  if (q_dtype == ft5::kBFloat16) return launch_kv<__nv_bfloat16>(kv_dtype, p, B, splits, warps, s);
  return cudaErrorInvalidValue;
}
