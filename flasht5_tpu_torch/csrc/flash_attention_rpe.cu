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
// bias window it needs into shared memory.
//
// Bound on the H100: at the slice's prefill shape (B 8, H 8, S 512, D 64)
// the work is 4*B*H*S*S*D = 4.3 GFLOP over about 25 MB of q, k, v and o,
// so operations bound it at the tensor-core rate. This first kernel does the
// products on the CUDA cores in fp32 (one CTA per (64-row q tile, head,
// batch), four threads per query row, K/V tiles of 64 rows in shared
// memory, online softmax in fp32). Moving QK^T and PV onto wgmma is the
// next step; the structure (K/V tiles streamed through shared memory, P
// kept on chip) stays.
//
// Rounding points mirror the TPU kernel: scores and the softmax in fp32, P
// rounded to the input type before the PV product, O rounded once. The
// bias is added in fp32 (the TPU path rounds it to the model dtype first).
//
// With table == nullptr (and no bucket array) the kernel adds no bias: it is
// then plain flash attention, the no-bias use of flasht5_tpu/ops/
// flash_attention.py (_fwd_kernel_nj1_bfold, _fwd_kernel), which the
// decoder's cross-attention runs.

#include "common.cuh"

namespace {

constexpr int kBM = 64;          // query rows per CTA
constexpr int kBN = 64;          // key rows per shared-memory tile
constexpr int kThreads = 256;    // four threads per query row
constexpr int kWin = kBM + kBN - 1;  // offsets one tile spans

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rpe_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ table,
               const int* __restrict__ bucket, T* __restrict__ o,
               float* __restrict__ lse, int H, int M, int N, int num_buckets,
               float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;                       // kBN x (D + 1)
  float* vs = ks + kBN * (D + 1);         // kBN x D
  float* ps = vs + kBN * D;               // kBM x (kBN + 1)
  float* ws = ps + kBM * (kBN + 1);       // num_buckets: table[:, h]
  float* bs = ws + num_buckets;           // kWin bias window of this tile

  const int tid = threadIdx.x;
  const int r = tid >> 2;                 // query row inside the tile
  const int sub = tid & 3;                // which quarter of the row
  const int i0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + h;
  const int row = i0 + r;
  const bool row_ok = row < M;
  const int offset = N - M;               // bottom-right causal alignment

  const bool has_bias = table != nullptr;
  if (has_bias)
    for (int t = tid; t < num_buckets; t += kThreads) ws[t] = table[t * H + h];

  float qr[D];
  const T* qrow = q + (bh * M + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_ok ? ft5::to_float(qrow[d]) : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) acc[e] = 0.f;
  float m_i = ft5::kNegInf, l_i = 0.f;

  int n_end = N;
  if (causal) n_end = min(N, i0 + kBM + offset);
  const T* kb = k + bh * N * D;
  const T* vb = v + bh * N * D;

  for (int j0 = 0; j0 < n_end; j0 += kBN) {
    __syncthreads();  // previous tile's readers are done (and ws is loaded)
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int jj = idx / D, dd = idx - jj * D;
      const int col = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (col < N) {
        kv = ft5::to_float(kb[static_cast<size_t>(col) * D + dd]);
        vv = ft5::to_float(vb[static_cast<size_t>(col) * D + dd]);
      }
      ks[jj * (D + 1) + dd] = kv;
      vs[jj * D + dd] = vv;
    }
    // bias of offsets j0 - i0 - (kBM - 1) .. j0 - i0 + kBN - 1; entries
    // outside [0, M + N - 2] only meet masked scores and are clamped
    for (int t = tid; t < kWin; t += kThreads) {
      int gi = j0 - i0 - (kBM - 1) + t + M - 1;
      gi = max(0, min(gi, M + N - 2));
      bs[t] = has_bias ? ws[bucket[gi]] : 0.f;
    }
    __syncthreads();

    float s[kBN / 4];
    unsigned live = 0;
    float mt = ft5::kNegInf;
#pragma unroll
    for (int c = 0; c < kBN / 4; ++c) {
      const int jj = sub + 4 * c;
      const int col = j0 + jj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qr[d] * ks[jj * (D + 1) + d];
      const bool ok = row_ok && col < N && (!causal || col <= row + offset);
      s[c] = ok ? dot * sm_scale + bs[jj - r + kBM - 1] : ft5::kNegInf;
      live |= static_cast<unsigned>(ok) << c;
      mt = fmaxf(mt, s[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m_i, mt);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kBN / 4; ++c) {
      const float p = ((live >> c) & 1u) ? expf(s[c] - m_new) : 0.f;
      psum += p;
      ps[r * (kBN + 1) + sub + 4 * c] = ft5::round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) acc[e] *= alpha;
    __syncthreads();  // P of all four quarters of every row is written
#pragma unroll 4
    for (int jj = 0; jj < kBN; ++jj) {
      const float p = ps[r * (kBN + 1) + jj];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) acc[e] += p * vs[jj * D + sub + 4 * e];
    }
  }

  if (!row_ok) return;
  const float l_safe = l_i > 0.f ? l_i : 1.f;
  T* orow = o + (bh * M + row) * D;
#pragma unroll
  for (int e = 0; e < D / 4; ++e)
    orow[sub + 4 * e] = ft5::from_float<T>(acc[e] / l_safe);
  if (sub == 0)
    lse[bh * M + row] = l_i > 0.f ? m_i + logf(l_safe) : ft5::kNegInf;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* table, const int* bucket, void* o, float* lse,
                   int B, int H, int M, int N, int num_buckets,
                   float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kBN * (D + 1) + kBN * D +
                                       kBM * (kBN + 1) + num_buckets + kWin);
  auto kernel = rpe_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((M + kBM - 1) / kBM, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, bucket, static_cast<T*>(o), lse, H, M,
      N, num_buckets, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const float* table, const int* bucket, void* o,
                       float* lse, int B, int H, int M, int N, int nb,
                       float sm_scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, table, bucket, o, lse, B, H, M, N,
                                  nb, sm_scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, table, bucket, o, lse, B, H, M, N,
                                  nb, sm_scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, table, bucket, o, lse, B, H, M,
                                    N, nb, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,M,D), k/v (B,H,N,D) in `dtype`; table (num_buckets, H) f32;
// bucket (M+N-1,) int32 with bucket[col - row + M - 1]; o (B,H,M,D) in
// `dtype`; lse (B,H,M) f32. All contiguous. table and bucket may both be
// null (num_buckets 0): no bias.
FT5_EXPORT int ft5_flash_attention_rpe_fwd(
    const void* q, const void* k, const void* v, const float* table,
    const int* bucket, void* o, float* lse, int B, int H, int M, int N, int D,
    int num_buckets, float sm_scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ft5::kFloat32)
    return dispatch_d<float>(D, q, k, v, table, bucket, o, lse, B, H, M, N,
                             num_buckets, sm_scale, causal, s);
  if (dtype == ft5::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, table, bucket, o, lse, B, H,
                                     M, N, num_buckets, sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
