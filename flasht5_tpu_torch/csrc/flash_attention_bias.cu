// Flash attention with an additive bias tensor: the materialized T5 bias of
// attention_type="pallas", with a padding mask folded in where use_masking
// asks for it. Forward, and the backward's two kernels.
//
// Replaces the bias uses of flasht5_tpu/ops/flash_attention.py: the forward
// _fwd_kernel (:90, pallas_call :325) with has_bias, the dK/dV + dbias kernel
// _bwd_dkv_kernel (:395, pallas_call :766, want_dbias) and the dQ kernel
// _bwd_dq_kernel (:561, pallas_call :798) given the bias. bf16 inputs take
// wgmma_attention.cuh's dkdv_wgmma_kernel and dq_wgmma_kernel on the bias
// tensor (TensorW: each thread reads its entries at its accumulator's
// coordinates from device memory, and writes dS there) and attention.cuh's
// fwd_mma_kernel (mma.sync) for the forward: the wgmma forward read the bias
// that way 3-14% slower at the encoder's shapes (PERF.md), where the
// mma.sync body stages it into shared memory by cp.async. f32 inputs take
// the CUDA-core forms (fwd_kernel, dkdv_kernel, dq_kernel) on TensorBiasT.
//
// The bias is (B|1, H|1, M, N) f32 with a contiguous last axis, read through
// its batch, head and row strides: a stride of 0 broadcasts that axis, so a
// (1, H, M, N) bias is never expanded in memory. The f32 kernels stage a
// 64 x 64 block of it a tile pair by coalesced row reads, row stride 68
// floats (their warps read 8 rows at once, four threads a row: 68 puts those
// rows in distinct banks); the bf16 forward a 128 x 64 block (32 KB) as part
// of its 2-stage cp.async ring, 16-byte copies zero-filled past N where the
// bias rows are 16-byte aligned (plain loads where they are not), row stride
// 72 floats: it reads (row, key pair) float2s at the accumulator fragments'
// coordinates, 8 rows by 4 pairs a warp, and 72 (8 mod 32 words) puts each
// half warp's pairs in distinct banks.
//
// dbias: the dK/dV kernel writes dS (fp32) of every (batch, head, row, col)
// into a (B, H, M, N) array, zeros for the rows a causal mask keeps from a
// CTA's keys; the wrapper sums it over the bias's broadcast axes, as the TPU
// path does (:811-822). Deterministic, no atomics.
//
// Bound on the H100, at the encoder's shape of the pretraining batch (B 64,
// H 8, M = N = 1024, D 64): the forward does 4 B H M N D = 137 GFLOP over
// ~0.3 GB, so operations bound it (0.14 ms at the bf16 tensor-core rate);
// the dK/dV kernel does 8 B H M N D (K Q^T, V dO^T, P^T dO, dS^T Q: 0.278
// ms) and the dQ kernel 6 B H M N D (0.208 ms). The per-batch dbias adds
// 2.1 GB of writes (and the wrapper's reduction reads them again) that a
// (1, H, M, N) dbias does not need. Reducing dbias over the batch on chip is
// later work.

#include "wgmma_attention.cuh"

using namespace ft5::attn;

namespace {

// A (BM x kBN) bias tile per tile pair, row stride LD floats, in NBUF
// buffers. The f32 kernels read it four threads to a row, 8 rows at once:
// LD 68 puts those rows in distinct banks. The bf16 forward reads (row g,
// keys 2 tq, 2 tq + 1) pairs at accumulator coordinates, 8 rows by 4
// pairs: LD 72 (8 mod 32 words) puts each half warp's 64-bit reads in
// distinct banks; with two buffers the tile is part of its cp.async ring
// (16-byte copies where the bias rows allow them, zero-filled past N). NT:
// the kernel's threads.
template <int BM, int LD, int NBUF, int NT>
struct TensorBiasT {
  const float* ptr;        // the bias
  long long sb, sh, sm;    // element strides of batch, head, row (0 on a
                           // broadcast axis); the last axis is contiguous
  float* dbias;            // dK/dV: (B, H, M, N) f32, or null
  bool vec;                // rows 16-byte aligned: cp.async can copy them
  const float* base;       // the (b, h) plane of the bias
  float* db;               // the (b, h) plane of dbias
  float* bt;               // shared: NBUF x BM x LD, the tile pair's bias

  __host__ int smem_floats(int) const { return NBUF * BM * LD; }
  __device__ void init(float* smem, int b, int h, int H, int M, int N) {
    bt = smem;
    base = ptr + b * sb + h * sh;
    if (dbias) db = dbias + (static_cast<size_t>(b) * H + h) * M * N;
  }
  // entries outside [0, M) x [0, N) only meet masked scores
  __device__ void stage(int i0, int j0, int M, int N, int buf = 0) {
    float* dst = bt + buf * BM * LD;
    if (NBUF > 1 && vec) {
      for (int idx = threadIdx.x; idx < BM * kBN / 4; idx += NT) {
        const int r = idx / (kBN / 4), c = (idx - r * (kBN / 4)) * 4;
        const int row = i0 + r, col = j0 + c;
        const int n_ok = row < M ? max(0, min(4, N - col)) : 0;
        ft5::mma::cp_async16(
            dst + r * LD + c,
            n_ok ? base + static_cast<long long>(row) * sm + col : base,
            4 * n_ok);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < BM * kBN; idx += NT) {
      const int r = idx / kBN, c = idx - r * kBN;
      const int row = i0 + r, col = j0 + c;
      dst[r * LD + c] =
          (row < M && col < N) ? base[static_cast<long long>(row) * sm + col]
                               : 0.f;
    }
  }
  __device__ float at(int ii, int jj, int buf = 0) const {
    return bt[buf * BM * LD + ii * LD + jj];
  }
  __device__ float2 pair(int ii, int jj, int buf) const {
    return *reinterpret_cast<const float2*>(bt + buf * BM * LD + ii * LD +
                                            jj);
  }
  __host__ __device__ bool keeps_ds() const { return dbias != nullptr; }
  // the rows above i_begin see none of the tile's keys: their dS is 0
  __device__ void skip(int i_begin, int j0, int, int N) {
    for (int idx = threadIdx.x; idx < i_begin * kBN; idx += NT) {
      const int row = idx / kBN, c = j0 + idx - row * kBN;
      if (c < N) db[static_cast<size_t>(row) * N + c] = 0.f;
    }
  }
  __device__ void sink(const float* ds_s, int ld, int i0, int j0, int M,
                       int N) {
    for (int idx = threadIdx.x; idx < BM * kBN; idx += NT) {
      const int r = idx / kBN, c = idx - r * kBN;
      if (i0 + r < M && j0 + c < N)
        db[static_cast<size_t>(i0 + r) * N + j0 + c] = ds_s[r * ld + c];
    }
  }
  __device__ void finish(float*, size_t, int, int, int) {}
};

// the f32 kernels'; the bf16 forward's
using TensorBias = TensorBiasT<kBM, kBN + 4, 1, kThreads>;
using TensorBiasFwd = TensorBiasT<kFwdBM, kBN + 8, 2, kFwdThreads>;

// the bf16 kernels' bias source; its key pairs are read 8 bytes at a time
// where every row is 8-byte aligned and N is even
wg::TensorW tensor(const float* bias, long long sb, long long sh,
                   long long sm, float* dbias, int N) {
  const bool pairs = reinterpret_cast<uintptr_t>(bias) % 8 == 0 &&
                     sb % 2 == 0 && sh % 2 == 0 && sm % 2 == 0 && N % 2 == 0;
  return wg::TensorW{bias, sb, sh, sm, dbias, pairs};
}

}  // namespace

// q, dout (B,H,M,D) and k, v (B,H,N,D) in `dtype`, contiguous; bias f32 with
// element strides bias_sb, bias_sh, bias_sm of its batch, head and row (0 on
// a broadcast axis) and a contiguous last axis; o like q; lse, delta (B,H,M)
// f32 (delta = rowsum(dout * o)); dq, dk, dv like q, k, v; dbias (B,H,M,N)
// f32, contiguous.
FT5_EXPORT int ft5_flash_attention_bias_fwd(
    const void* q, const void* k, const void* v, const float* bias,
    long long bias_sb, long long bias_sh, long long bias_sm, void* o,
    float* lse, int B, int H, int M, int N, int D, float sm_scale, int causal,
    int dtype, void* stream) {
  if (dtype == ft5::kBFloat16) {
    const bool vec = reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
                     bias_sb % 4 == 0 && bias_sh % 4 == 0 && bias_sm % 4 == 0;
    return launch_fwd_mma(
        TensorBiasFwd{bias, bias_sb, bias_sh, bias_sm, nullptr, vec}, q, k, v,
        o, lse, B, H, M, N, D, sm_scale, causal, stream);
  }
  if (dtype != ft5::kFloat32) return cudaErrorInvalidValue;
  const TensorBias bv{bias, bias_sb, bias_sh, bias_sm, nullptr};
  return launch_fwd_f32(bv, q, k, v, o, lse, B, H, M, N, D, sm_scale, causal,
                        stream);
}

FT5_EXPORT int ft5_flash_attention_bias_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias,
    long long bias_sb, long long bias_sh, long long bias_sm, void* dk,
    void* dv, float* dbias, int B, int H, int M, int N, int D,
    float sm_scale, int causal, int dtype, void* stream) {
  if (dtype == ft5::kBFloat16)
    return wg::launch_dkdv<wg::kTensorBias>(
        wg::TableW{}, tensor(bias, bias_sb, bias_sh, bias_sm, dbias, N), q, k,
        v, dout, lse, delta, dk, dv, B, H, M, N, D, sm_scale, causal, stream);
  if (dtype != ft5::kFloat32) return cudaErrorInvalidValue;
  const TensorBias bv{bias, bias_sb, bias_sh, bias_sm, dbias};
  return launch_dkdv_f32(bv, q, k, v, dout, lse, delta, dk, dv, B, H, M, N,
                         D, sm_scale, causal, stream);
}

FT5_EXPORT int ft5_flash_attention_bias_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias,
    long long bias_sb, long long bias_sh, long long bias_sm, void* dq, int B,
    int H, int M, int N, int D, float sm_scale, int causal, int dtype,
    void* stream) {
  if (dtype == ft5::kBFloat16)
    return wg::launch_dq<wg::kTensorBias>(
        wg::TableW{}, tensor(bias, bias_sb, bias_sh, bias_sm, nullptr, N), q,
        k, v, dout, lse, delta, dq, B, H, M, N, D, sm_scale, causal, stream);
  if (dtype != ft5::kFloat32) return cudaErrorInvalidValue;
  const TensorBias bv{bias, bias_sb, bias_sh, bias_sm, nullptr};
  return launch_dq_f32(bv, q, k, v, dout, lse, delta, dq, B, H, M, N, D,
                       sm_scale, causal, stream);
}
