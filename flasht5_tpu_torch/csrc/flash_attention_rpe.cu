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
// col - row, computed once on the CPU, and each tile pair stages the bias
// window it needs into shared memory (wgmma_attention.cuh's TableW; the f32
// kernel's attention.cuh's TableBias).
//
// Bound on the H100: at the encoder's shape (B 8, H 8, M = N = 1024, D 64)
// the work is 4*B*H*M*N*D = 17.2 GFLOP over about 34 MB of q, k, v and o,
// so operations bound it at the tensor-core rate (0.0174 ms at 989
// TFLOP/s). bf16 inputs take wgmma_attention.cuh's fwd_wgmma_kernel
// (FlashAttention-3's shape: a TMA producer warp, two consumer warpgroups
// of 64 query rows, S and PV on wgmma, P passed in registers); the producer
// gathers the bias window of each tile pair from the table into the ring's
// stage beside the K and V tiles. f32 inputs take fwd_kernel, the
// CUDA-core form (64-row tiles, 127-entry windows).
//
// Rounding points mirror the TPU kernel: scores and the softmax in fp32, P
// rounded to the input type before the PV product, O rounded once. The
// bias is added in fp32 (the TPU path rounds it to the model dtype first).
//
// With table == nullptr (and no bucket array) the kernel adds no bias: it is
// then plain flash attention, the no-bias use of flasht5_tpu/ops/
// flash_attention.py (_fwd_kernel_nj1_bfold, _fwd_kernel), which the
// decoder's cross-attention runs.

#include "wgmma_attention.cuh"

using namespace ft5::attn;

// q (B,H,M,D), k/v (B,H,N,D) in `dtype`; table (num_buckets, H) f32;
// bucket (M+N-1,) int32 with bucket[col - row + M - 1]; o (B,H,M,D) in
// `dtype`; lse (B,H,M) f32. All contiguous (bf16: 16-byte aligned, D 64 or
// 128; f32: D 32, 64 or 128). table and bucket may both be null
// (num_buckets 0): no bias.
FT5_EXPORT int ft5_flash_attention_rpe_fwd(
    const void* q, const void* k, const void* v, const float* table,
    const int* bucket, void* o, float* lse, int B, int H, int M, int N, int D,
    int num_buckets, float sm_scale, int causal, int dtype, void* stream) {
  const int nb = table ? num_buckets : 0;
  if (dtype == ft5::kBFloat16) {
    const wg::TableW tw{table, bucket, nb, nullptr};
    return (table ? wg::launch_fwd<wg::kTableBias>
                  : wg::launch_fwd<wg::kNoBias>)(tw, q, k, v, o, lse, B, H, M,
                                                 N, D, sm_scale, causal,
                                                 stream);
  }
  if (dtype != ft5::kFloat32) return cudaErrorInvalidValue;
  const TableBias bias{table, bucket, nb, nullptr};
  return launch_fwd_f32(bias, q, k, v, o, lse, B, H, M, N, D, sm_scale,
                        causal, stream);
}

// wgmma's MN-major B operand alone (wgmma_attention.cuh's
// wgmma_mn_check_kernel): a (64, 64) and b (64, N) bf16, row-major, 16-byte
// aligned, N 64 or 128; c_ss and c_rs (64, N) f32, a b with A from shared
// memory and from registers.
FT5_EXPORT int ft5_wgmma_mn_check(const void* a, const void* b, float* c_ss,
                                  float* c_rs, int N, void* stream) {
  return wg::launch_mn_check(a, b, c_ss, c_rs, N, stream);
}
