// Flash attention backward, with the gradient of the T5 bucket table when a
// table is given and without bias when it is not.
//
// Replaces the Pallas backward kernels of flasht5_tpu/ops/flash_attention_rpe.py
// (_bwd_fused_kernel_nj1_bfold, _bwd_fused_kernel_nj1, _bwd_fused_kernel, and
// the two-pass _bwd_dkv_kernel / _bwd_dq_kernel) and the no-bias uses of
// flasht5_tpu/ops/flash_attention.py's backward (_bwd_fused_nj1_bfold_kernel,
// _bwd_fused_nj1_kernel, _bwd_dkv_kernel, _bwd_dq_kernel). One entry point,
// two kernels, the two-pass form of the TPU's _bwd_dkv / _bwd_dq pair:
//
// - dkdv: one CTA per (64-key tile, head, batch) keeps its keys' K and V rows
//   and their dK and dV sums in registers and walks the query tiles. For each
//   (query row, key) it recomputes P = exp(s * scale + bias - lse) from the
//   saved log-sum-exp, then dP = dO . v, dS = P (dP - delta), and adds
//   P dO to dV and dS q to dK. With a table it also sums dS along each
//   diagonal (one offset col - row) of every tile into shared memory and, at
//   the end, those per-offset sums into one row of num_buckets floats per CTA
//   through the bucket of each offset. The wrapper sums those rows in a fixed
//   order: dW is deterministic, and no global float atomics are used.
// - dq: one CTA per (64-row query tile, head, batch) keeps its rows' q, dO and
//   dQ sums in registers, streams K and V tiles through shared memory, and
//   recomputes P and dS the same way.
//
// The bias is added after the scale, as the forward kernel does, so
// dW[bucket, h] = sum of dS over every (row, col) whose offset has that
// bucket. The wrapper passes the (M + N - 1,) int32 bucket of every offset
// (bucket[col - row + M - 1]), computed on the CPU, so no log is evaluated
// here. Causal masking is bottom-right aligned; rows with no visible key
// (lse = -1e30) contribute nothing.
//
// Rounding points mirror the TPU kernels: scores, P, dP and dS in fp32; P
// rounded to the input type before the P^T dO product, dS rounded to it
// before the dS^T q and dS k products, sums in fp32, each output rounded once
// (dQ and dK after the scale).
//
// Bound on the H100: operations. At the encoder's shape (B 8, H 8, M = N =
// 1024, D 64) the backward does 10 B H M N D = 42.9 GFLOP (5 products) over
// about 50 MB. This first form does the products on the CUDA cores in fp32:
// four threads share each key (or query row) and split D into interleaved
// float4 chunks, so the four threads of a row read 64 contiguous bytes of a
// shared-memory row and reduce their partial dots with two shuffles. Moving
// the products onto wgmma is later work; the structure (one operand resident,
// the other streamed through shared memory) stays.

#include "common.cuh"

namespace {

constexpr int kBM = 64;              // query rows per tile
constexpr int kBN = 64;              // key rows per tile
constexpr int kThreads = 256;        // four threads per key / query row
constexpr int kWin = kBM + kBN - 1;  // offsets one tile spans
constexpr int kMaxBuckets = kThreads;

// Thread `sub` (0..3) of a row owns the columns 16u + 4 sub + {0..3}.
template <int D>
__device__ __forceinline__ float dot_part(const float* row_s, const float* reg,
                                          int sub) {
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < D / 16; ++u) {
    const float4 x = *reinterpret_cast<const float4*>(row_s + 16 * u + 4 * sub);
    acc += x.x * reg[4 * u] + x.y * reg[4 * u + 1] + x.z * reg[4 * u + 2] +
           x.w * reg[4 * u + 3];
  }
  return acc;
}

// the sum over the four threads of a row (lanes 4r .. 4r + 3); every one of
// them gets the same value
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T, int D>
__device__ __forceinline__ void load_part(const T* row, bool ok, int sub,
                                          float* reg) {
#pragma unroll
  for (int u = 0; u < D / 16; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      reg[4 * u + c] = ok ? ft5::to_float(row[16 * u + 4 * sub + c]) : 0.f;
}

template <int D>
__device__ __forceinline__ void axpy_part(float a, const float* row_s,
                                          int sub, float* acc) {
#pragma unroll
  for (int u = 0; u < D / 16; ++u) {
    const float4 x = *reinterpret_cast<const float4*>(row_s + 16 * u + 4 * sub);
    acc[4 * u] += a * x.x;
    acc[4 * u + 1] += a * x.y;
    acc[4 * u + 2] += a * x.z;
    acc[4 * u + 3] += a * x.w;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_part(T* row, int sub, const float* reg,
                                           float scale) {
#pragma unroll
  for (int u = 0; u < D / 16; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      row[16 * u + 4 * sub + c] = ft5::from_float<T>(reg[4 * u + c] * scale);
}

// bias of the offsets j0 - i0 - (kBM - 1) .. j0 - i0 + kBN - 1 into bs;
// offsets outside [-(M - 1), N - 1] only meet masked scores and are clamped
__device__ __forceinline__ void stage_bias(float* bs, const float* ws,
                                           const int* bucket, int i0, int j0,
                                           int M, int N) {
  for (int t = threadIdx.x; t < kWin; t += kThreads) {
    int gi = j0 - i0 - (kBM - 1) + t + M - 1;
    gi = max(0, min(gi, M + N - 2));
    bs[t] = ws[bucket[gi]];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ table, const int* __restrict__ bucket,
                T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dw_part, int H, int M, int N,
                int num_buckets, float sm_scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBM x D
  float* dos = qs + kBM * D;                    // kBM x D
  float* lse_s = dos + kBM * D;                 // kBM
  float* delta_s = lse_s + kBM;                 // kBM
  float* ds_s = delta_s + kBM;                  // kBM x (kBN + 1)
  float* ws = ds_s + kBM * (kBN + 1);           // num_buckets: table[:, h]
  float* bs = ws + num_buckets;                 // kWin
  float* doff = bs + kWin;                      // n_off sums of dS by offset

  const int tid = threadIdx.x;
  const int jj = tid >> 2;  // key inside the tile
  const int sub = tid & 3;
  const int j0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + h;
  const int col = j0 + jj;
  const bool col_ok = col < N;
  const int offset = N - M;  // bottom-right causal alignment
  const bool has_bias = table != nullptr;
  // doff[e] holds offset e - (Mp - 1) + j0, Mp being M rounded up to kBM
  const int Mp = (M + kBM - 1) / kBM * kBM;
  const int n_off = Mp + kBN - 1;

  if (has_bias) {
    for (int t = tid; t < num_buckets; t += kThreads) ws[t] = table[t * H + h];
    for (int t = tid; t < n_off; t += kThreads) doff[t] = 0.f;
  }

  float kr[D / 4], vr[D / 4], dkr[D / 4], dvr[D / 4];
  const size_t krow = (bh * N + (col_ok ? col : 0)) * D;
  load_part<T, D>(k + krow, col_ok, sub, kr);
  load_part<T, D>(v + krow, col_ok, sub, vr);
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dkr[e] = dvr[e] = 0.f;

  // the first query tile with a row that sees a key of this tile
  const int i_begin = causal ? max(0, j0 - offset) / kBM * kBM : 0;
  for (int i0 = i_begin; i0 < M; i0 += kBM) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBM * D; idx += kThreads) {
      const int ii = idx / D;
      const int row = i0 + ii;
      const size_t g = (bh * M + row) * D + (idx - ii * D);
      qs[idx] = row < M ? ft5::to_float(q[g]) : 0.f;
      dos[idx] = row < M ? ft5::to_float(dout[g]) : 0.f;
    }
    for (int t = tid; t < kBM; t += kThreads) {
      const int row = i0 + t;
      lse_s[t] = row < M ? lse[bh * M + row] : ft5::kNegInf;
      delta_s[t] = row < M ? delta[bh * M + row] : 0.f;
    }
    if (has_bias) stage_bias(bs, ws, bucket, i0, j0, M, N);
    __syncthreads();

    for (int ii = 0; ii < kBM; ++ii) {
      const int row = i0 + ii;
      const float s = row_sum(dot_part<D>(qs + ii * D, kr, sub));
      const float dp = row_sum(dot_part<D>(dos + ii * D, vr, sub));
      const float l = lse_s[ii];
      const bool ok = col_ok && row < M && l > ft5::kNegInf / 2 &&
                      (!causal || col <= row + offset);
      float p = 0.f, ds = 0.f;
      if (ok) {
        const float b = has_bias ? bs[jj - ii + kBM - 1] : 0.f;
        p = expf(s * sm_scale + b - l);
        ds = p * (dp - delta_s[ii]);
      }
      axpy_part<D>(ft5::round_to<T>(p), dos + ii * D, sub, dvr);
      axpy_part<D>(ft5::round_to<T>(ds), qs + ii * D, sub, dkr);
      if (has_bias && sub == 0) ds_s[ii * (kBN + 1) + jj] = ds;
    }

    if (has_bias) {
      __syncthreads();  // dS of the whole tile is in ds_s
      // thread t sums diagonal t (jj - ii = t - (kBM - 1)) of the tile, in
      // row order, into its offset's slot
      for (int t = tid; t < kWin; t += kThreads) {
        const int d0 = t - (kBM - 1);
        float acc = 0.f;
        for (int ii = max(0, -d0); ii < kBM && ii + d0 < kBN; ++ii)
          acc += ds_s[ii * (kBN + 1) + ii + d0];
        doff[d0 - i0 + Mp - 1] += acc;
      }
    }
  }

  const size_t orow = (bh * N + col) * D;
  if (col_ok) {
    store_part<T, D>(dk + orow, sub, dkr, sm_scale);
    store_part<T, D>(dv + orow, sub, dvr, 1.f);
  }

  if (has_bias) {
    // per-offset sums into buckets: `parts` threads per bucket each scan a
    // contiguous share of the offsets, then one thread adds the shares in
    // order (ds_s is free again and holds them)
    __syncthreads();
    const int parts = kThreads / num_buckets;
    const int nb = tid / parts, part = tid - nb * parts;
    if (nb < num_buckets) {
      const int chunk = (n_off + parts - 1) / parts;
      const int e_end = min(n_off, (part + 1) * chunk);
      float acc = 0.f;
      for (int e = part * chunk; e < e_end; ++e) {
        const int gi = e - (Mp - 1) + j0 + M - 1;  // bucket index of offset
        if (gi >= 0 && gi <= M + N - 2 && bucket[gi] == nb) acc += doff[e];
      }
      ds_s[tid] = acc;
    }
    __syncthreads();
    if (tid < num_buckets) {
      float acc = 0.f;
      for (int p = 0; p < parts; ++p) acc += ds_s[tid * parts + p];
      dw_part[(bh * gridDim.x + blockIdx.x) * num_buckets + tid] = acc;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const float* __restrict__ table, const int* __restrict__ bucket,
              T* __restrict__ dq, int H, int M, int N, int num_buckets,
              float sm_scale, int causal) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBN x D
  float* vs = ks + kBN * D;                     // kBN x D
  float* ws = vs + kBN * D;                     // num_buckets
  float* bs = ws + num_buckets;                 // kWin

  const int tid = threadIdx.x;
  const int ii = tid >> 2;  // query row inside the tile
  const int sub = tid & 3;
  const int i0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + h;
  const int row = i0 + ii;
  const bool row_ok = row < M;
  const int offset = N - M;
  const bool has_bias = table != nullptr;

  if (has_bias)
    for (int t = tid; t < num_buckets; t += kThreads) ws[t] = table[t * H + h];

  float qr[D / 4], dor[D / 4], dqr[D / 4];
  const size_t qrow = (bh * M + (row_ok ? row : 0)) * D;
  load_part<T, D>(q + qrow, row_ok, sub, qr);
  load_part<T, D>(dout + qrow, row_ok, sub, dor);
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dqr[e] = 0.f;
  const float l = row_ok ? lse[bh * M + row] : ft5::kNegInf;
  const float dl = row_ok ? delta[bh * M + row] : 0.f;

  int n_end = N;
  if (causal) n_end = min(N, i0 + kBM + offset);
  const T* kb = k + bh * N * D;
  const T* vb = v + bh * N * D;
  for (int j0 = 0; j0 < n_end; j0 += kBN) {
    __syncthreads();  // the previous tile's readers are done (ws is loaded)
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int c = j0 + idx / D;
      const size_t g = static_cast<size_t>(j0) * D + idx;
      ks[idx] = c < N ? ft5::to_float(kb[g]) : 0.f;
      vs[idx] = c < N ? ft5::to_float(vb[g]) : 0.f;
    }
    if (has_bias) stage_bias(bs, ws, bucket, i0, j0, M, N);
    __syncthreads();

    for (int jj = 0; jj < kBN; ++jj) {
      const int col = j0 + jj;
      const float s = row_sum(dot_part<D>(ks + jj * D, qr, sub));
      const float dp = row_sum(dot_part<D>(vs + jj * D, dor, sub));
      const bool ok = row_ok && col < N && l > ft5::kNegInf / 2 &&
                      (!causal || col <= row + offset);
      float ds = 0.f;
      if (ok) {
        const float b = has_bias ? bs[jj - ii + kBM - 1] : 0.f;
        ds = expf(s * sm_scale + b - l) * (dp - dl);
      }
      axpy_part<D>(ft5::round_to<T>(ds), ks + jj * D, sub, dqr);
    }
  }
  if (row_ok) store_part<T, D>(dq + qrow, sub, dqr, sm_scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const float* table, const int* bucket, void* dq, void* dk,
                   void* dv, float* dw_part, int B, int H, int M, int N,
                   int num_buckets, float sm_scale, int causal,
                   cudaStream_t stream) {
  const int nb = table ? num_buckets : 0;
  const int n_off = table ? (M + kBM - 1) / kBM * kBM + kBN - 1 : 0;
  const size_t smem_a = sizeof(float) * (2 * kBM * D + 2 * kBM +
                                         kBM * (kBN + 1) + nb + kWin + n_off);
  const size_t smem_b = sizeof(float) * (2 * kBN * D + nb + kWin);
  auto ka = bwd_dkdv_kernel<T, D>;
  auto kb = bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  ka<<<dim3((N + kBN - 1) / kBN, H, B), kThreads, smem_a, stream>>>(
      tq, tk, tv, tdo, lse, delta, table, bucket, static_cast<T*>(dk),
      static_cast<T*>(dv), dw_part, H, M, N, nb, sm_scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kb<<<dim3((M + kBM - 1) / kBM, H, B), kThreads, smem_b, stream>>>(
      tq, tk, tv, tdo, lse, delta, table, bucket, static_cast<T*>(dq), H, M,
      N, nb, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* table, const int* bucket, void* dq,
                       void* dk, void* dv, float* dw_part, int B, int H,
                       int M, int N, int nb, float sm_scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, table, bucket,
                                  dq, dk, dv, dw_part, B, H, M, N, nb,
                                  sm_scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, table, bucket,
                                  dq, dk, dv, dw_part, B, H, M, N, nb,
                                  sm_scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, table, bucket,
                                    dq, dk, dv, dw_part, B, H, M, N, nb,
                                    sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ft5::kFloat32)
    return dispatch_d<float>(D, q, k, v, dout, lse, delta, table, bucket, dq,
                             dk, dv, dw_part, B, H, M, N, num_buckets,
                             sm_scale, causal, s);
  if (dtype == ft5::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, table,
                                     bucket, dq, dk, dv, dw_part, B, H, M, N,
                                     num_buckets, sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
