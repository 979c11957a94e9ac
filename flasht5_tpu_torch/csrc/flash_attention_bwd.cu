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
// about 50 MB: 0.0434 ms at the bf16 tensor-core rate. bf16 inputs take
// attention.cuh's tensor-core kernels (dkdv_mma_kernel: 64-key CTAs, S^T and
// dP^T on mma.sync, P^T and dS^T rounded into A fragments in registers;
// dq_mma_kernel: the forward's 128-row layout with Q and dO in registers),
// the bias window gathered from the table into a 2-stage ring beside the
// Q/dO (dK/dV) or K/V (dQ) tiles. f32 inputs take the CUDA-core kernels
// (dkdv_kernel, dq_kernel), which the port keeps for them (no TF32).

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
  const int nb = table ? num_buckets : 0;
  float* dw = table ? dw_part : nullptr;
  const TableBias bias{table, bucket, nb, dw};
  const TableBiasBwd mma_bias{table, bucket, nb, dw};
  const TableBias dq_bias{table, bucket, nb, nullptr};
  const TableBiasFwd mma_dq_bias{table, bucket, nb, nullptr};
  cudaError_t err = launch_dkdv(bias, mma_bias, dtype, q, k, v, dout, lse,
                                delta, dk, dv, B, H, M, N, D, sm_scale,
                                causal, stream);
  if (err != cudaSuccess) return err;
  return launch_dq(dq_bias, mma_dq_bias, dtype, q, k, v, dout, lse, delta,
                   dq, B, H, M, N, D, sm_scale, causal, stream);
}
