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
// window it needs into shared memory (attention.cuh's TableBiasT).
//
// Bound on the H100: at the encoder's shape (B 8, H 8, M = N = 1024, D 64)
// the work is 4*B*H*M*N*D = 17.2 GFLOP over about 34 MB of q, k, v and o,
// so operations bound it at the tensor-core rate (0.0174 ms at 989
// TFLOP/s). bf16 inputs take attention.cuh's fwd_mma_kernel: 128-row query
// tiles, Q in registers, K/V tiles of 64 keys through a 2-stage cp.async
// ring, S and PV on mma.sync m16n8k16, P passed in registers. The 191-entry
// bias window of each (128-row, 64-key) tile pair is gathered from the
// table in shared memory into one of two buffers while the previous tile
// is used, and read at the accumulator fragments' coordinates. f32 inputs
// take fwd_kernel, the CUDA-core form (64-row tiles, 127-entry windows).
// wgmma with P as a register operand (FlashAttention-3's layout) and a
// warp-specialized TMA producer are later steps.
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
  const int nb = table ? num_buckets : 0;
  const TableBias bias{table, bucket, nb, nullptr};
  const TableBiasFwd mma_bias{table, bucket, nb, nullptr};
  return launch_fwd(bias, mma_bias, dtype, q, k, v, o, lse, B, H, M, N, D,
                    sm_scale, causal, stream);
}
