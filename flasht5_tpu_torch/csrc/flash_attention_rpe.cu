// Flash attention forward with the T5 relative-position bias read from the
// (num_buckets, H) bucket table inside the kernel.
//
// Replaces the Pallas forward kernels of flasht5_tpu/ops/flash_attention_rpe.py
// (_fwd_kernel_nj1_bfold, _fwd_kernel_nj1, flash_attention._fwd_kernel fed the
// offset table, and _fwd_kernel with its in-kernel select chain): one kernel
// covers all four. The TPU's offset table and select chain exist because
// Mosaic has no cheap gather; shared memory has one, so the bias costs one
// indexed shared-memory read per score and linear memory in M and N.
//
// Bucket exactness: the T5 bucket of an offset is a truncated float32 log
// that lands exactly on integers at some offsets, so the kernel evaluates no
// log. The wrapper passes the (M + N - 1,) int32 bucket of every offset
// col - row, computed once on the CPU, and each tile stages the 127-entry
// bias window it needs into shared memory (attention.cuh's TableBias).
//
// Bound on the H100: at the slice's prefill shape (B 8, H 8, S 512, D 64)
// the work is 4*B*H*S*S*D = 4.3 GFLOP over about 25 MB of q, k, v and o,
// so operations bound it at the tensor-core rate. The kernel body is
// attention.cuh's fwd_kernel: products on the CUDA cores in fp32, one CTA
// per (64-row q tile, head, batch), four threads per query row, K/V tiles of
// 64 rows in shared memory, online softmax in fp32. Moving QK^T and PV onto
// wgmma is the next step.
//
// Rounding points mirror the TPU kernel: scores and the softmax in fp32, P
// rounded to the input type before the PV product, O rounded once. The
// bias is added in fp32 (the TPU path rounds it to the model dtype first).
//
// With table == nullptr (and no bucket array) the kernel adds no bias: it is
// then plain flash attention, the no-bias use of flasht5_tpu/ops/
// flash_attention.py (_fwd_kernel_nj1_bfold, _fwd_kernel), which the
// decoder's cross-attention runs.

#include "attention.cuh"

using namespace ft5::attn;

// q (B,H,M,D), k/v (B,H,N,D) in `dtype`; table (num_buckets, H) f32;
// bucket (M+N-1,) int32 with bucket[col - row + M - 1]; o (B,H,M,D) in
// `dtype`; lse (B,H,M) f32. All contiguous. table and bucket may both be
// null (num_buckets 0): no bias.
FT5_EXPORT int ft5_flash_attention_rpe_fwd(
    const void* q, const void* k, const void* v, const float* table,
    const int* bucket, void* o, float* lse, int B, int H, int M, int N, int D,
    int num_buckets, float sm_scale, int causal, int dtype, void* stream) {
  const TableBias bias{table, bucket, table ? num_buckets : 0, nullptr};
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    return launch(fwd_kernel<T, kD, TableBias>, query_grid(B, H, M),
                  fwd_smem_floats<kD>() + bias.smem_floats(M), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), bias, static_cast<T*>(o), lse, H,
                  M, N, sm_scale, causal);
  });
}
