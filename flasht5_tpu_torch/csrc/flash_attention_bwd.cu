// Flash attention backward, with the gradient of the T5 bucket table when a
// table is given and without bias when it is not.
//
// Replaces the Pallas backward kernels of flasht5_tpu/ops/flash_attention_rpe.py
// (_bwd_fused_kernel_nj1_bfold, _bwd_fused_kernel_nj1, _bwd_fused_kernel, and
// the two-pass _bwd_dkv_kernel / _bwd_dq_kernel) and the no-bias uses of
// flasht5_tpu/ops/flash_attention.py's backward (_bwd_fused_nj1_bfold_kernel,
// _bwd_fused_nj1_kernel, _bwd_dkv_kernel, _bwd_dq_kernel). One entry point,
// two kernels, the two-pass form of the TPU's _bwd_dkv / _bwd_dq pair:
// attention.cuh's dkdv_kernel and dq_kernel on the bucket table's bias
// source (TableBias).
//
// The bias is added after the scale, as the forward kernel does, so
// dW[bucket, h] = sum of dS over every (row, col) whose offset has that
// bucket. The dK/dV kernel sums dS along each diagonal (one offset col - row)
// of every tile into shared memory and, at the end, those per-offset sums
// into one row of num_buckets floats per CTA through the bucket of each
// offset. The wrapper sums those rows in a fixed order: dW is deterministic,
// and no global float atomics are used. The wrapper passes the (M + N - 1,)
// int32 bucket of every offset (bucket[col - row + M - 1]), computed on the
// CPU, so no log is evaluated here.
//
// Bound on the H100: operations. At the encoder's shape (B 8, H 8, M = N =
// 1024, D 64) the backward does 10 B H M N D = 42.9 GFLOP (5 products) over
// about 50 MB. This first form does the products on the CUDA cores in fp32
// (attention.cuh says how); moving them onto wgmma is later work.

#include "attention.cuh"

using namespace ft5::attn;

// q, dout (B,H,M,D) and k, v (B,H,N,D) in `dtype`; lse, delta (B,H,M) f32
// (delta = rowsum(dout * o)); table (num_buckets, H) f32 and bucket (M+N-1,)
// int32 with bucket[col - row + M - 1], or both null for no bias; dq, dk, dv
// like q, k, v; dw_part (B, H, ceil(N / 64), num_buckets) f32, or null
// without a table. All contiguous. num_buckets <= 256.
FT5_EXPORT int ft5_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* table,
    const int* bucket, void* dq, void* dk, void* dv, float* dw_part, int B,
    int H, int M, int N, int D, int num_buckets, float sm_scale, int causal,
    int dtype, void* stream) {
  if (table != nullptr && (num_buckets < 1 || num_buckets > kMaxBuckets))
    return cudaErrorInvalidValue;
  // the dK/dV kernel writes dW's rows; the dQ kernel only reads the table
  const TableBias bias{table, bucket, table ? num_buckets : 0,
                       table ? dw_part : nullptr};
  const TableBias dq_bias{table, bucket, bias.num_buckets, nullptr};
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    cudaError_t err = launch(
        dkdv_kernel<T, kD, TableBias>, key_grid(B, H, N),
        dkdv_smem_floats<kD>() + bias.smem_floats(M), stream, tq, tk,
        tv, tdo, lse, delta, bias, static_cast<T*>(dk), static_cast<T*>(dv),
        H, M, N, sm_scale, causal);
    if (err != cudaSuccess) return err;
    return launch(dq_kernel<T, kD, TableBias>, query_grid(B, H, M),
                  dq_smem_floats<kD>() + dq_bias.smem_floats(M), stream, tq,
                  tk, tv, tdo, lse, delta, dq_bias, static_cast<T*>(dq), H,
                  M, N, sm_scale, causal);
  });
}
