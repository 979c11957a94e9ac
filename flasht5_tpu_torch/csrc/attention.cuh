// The flash attention kernels of the port, written once and instantiated on a
// bias source: the forward (flash_attention_rpe.cu, flash_attention_bias.cu)
// and the backward's dK/dV and dQ kernels (flash_attention_bwd.cu,
// flash_attention_bias.cu).
//
// - fwd: one CTA per (64-row query tile, head, batch), four threads per query
//   row, K/V tiles of 64 rows streamed through shared memory, online softmax
//   in fp32; writes o and lse (-1e30 for a row with no visible key).
// - dkdv: one CTA per (64-key tile, head, batch) keeps its keys' K and V rows
//   and their dK and dV sums in registers and walks the query tiles. For each
//   (query row, key) it recomputes P = exp(s * scale + bias - lse) from the
//   saved log-sum-exp, then dP = dO . v, dS = P (dP - delta), and adds P dO
//   to dV and dS q to dK; the bias source takes each tile's dS.
// - dq: one CTA per (64-row query tile, head, batch) keeps its rows' q, dO and
//   dQ sums in registers, streams K and V tiles through shared memory, and
//   recomputes P and dS the same way.
//
// Causal masking is bottom-right aligned; rows with no visible key (lse =
// -1e30) contribute nothing. Scores are s * scale + bias in fp32, the TPU
// kernels' order.
//
// Rounding points mirror the TPU kernels: scores, P, dP and dS in fp32; P
// rounded to the input type before the PV and P^T dO products, dS rounded to
// it before the dS^T q and dS k products, sums in fp32, each output rounded
// once (dQ and dK after the scale).
//
// The products run on the CUDA cores in fp32: four threads share each key or
// query row and split D into interleaved float4 chunks, so the four threads
// of a row read 64 contiguous bytes of a shared-memory row and reduce their
// partial dots with two shuffles. Moving them onto wgmma is later work; the
// structure (one operand resident, the other streamed through shared memory)
// stays.
//
// A bias source `Bias` is a struct passed by value to the kernels:
//   smem_floats(M)            floats of shared memory it takes (host side)
//   init(smem, b, h, H, M, N) once per CTA, before the first tile
//   stage(i0, j0, M, N)       the bias of the tile pair at query rows i0..,
//                             keys j0.. into shared memory (the kernel syncs
//                             before reading it)
//   at(ii, jj)                the bias of row i0 + ii, key j0 + jj
//   keeps_ds()                whether the dK/dV kernel hands it dS
//   skip(i_begin, j0, M, N)   dK/dV: the rows above i_begin, which a causal
//                             mask keeps from every key of the tile (dS 0)
//   sink(ds_s, i0, j0, M, N)  dK/dV: the tile pair's dS, in ds_s with row
//                             stride kLd, after a sync
//   finish(scratch, bh, j0, M, N)  dK/dV: after the last tile; scratch is
//                             the kBM * kLd floats of ds_s, free again
// TableBias below reads the T5 bucket table; flash_attention_bias.cu has the
// bias tensor's source.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ft5 {

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
      reg[4 * u + c] = ok ? to_float(row[16 * u + 4 * sub + c]) : 0.f;
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
      row[16 * u + 4 * sub + c] = from_float<T>(reg[4 * u + c] * scale);
}

namespace attn {

constexpr int kBM = 64;              // query rows per tile
constexpr int kBN = 64;              // key rows per tile
constexpr int kThreads = 256;        // four threads per query / key row
constexpr int kLd = kBN + 1;         // row stride of the P and dS tiles
constexpr int kWin = kBM + kBN - 1;  // offsets col - row one tile pair spans
constexpr int kMaxBuckets = kThreads;

// The T5 bias read from the (num_buckets, H) bucket table through the
// (M + N - 1,) int32 bucket of every offset col - row (bucket[col - row +
// M - 1], computed on the CPU, so no log is evaluated here); no bias when
// the table is null. Each tile pair stages the kWin-entry window of the
// offsets it spans. With dw_part, the dK/dV kernel sums dS along each
// diagonal (one offset) of every tile into shared memory and, at the end,
// those per-offset sums into one row of num_buckets floats per CTA through
// the bucket of each offset; the wrapper sums those rows in a fixed order,
// so dW is deterministic without global float atomics.
struct TableBias {
  const float* table;  // (num_buckets, H) f32, or null
  const int* bucket;   // (M + N - 1,) int32
  int num_buckets;     // 0 without a table
  float* dw_part;      // (B, H, ceil(N / kBN), num_buckets) f32, or null
  float* ws;           // shared: table[:, h]
  float* bs;           // shared: the kWin bias window of the tile pair
  float* doff;         // shared: sums of dS by offset (dK/dV)
  int Mp;              // M rounded up to kBM; doff[e] holds offset
                       // e - (Mp - 1) + j0

  static __host__ __device__ int n_off(int M) {
    return (M + kBM - 1) / kBM * kBM + kBN - 1;
  }
  __host__ int smem_floats(int M) const {
    return table ? num_buckets + kWin + (dw_part ? n_off(M) : 0) : 0;
  }
  __device__ void init(float* smem, int, int h, int H, int M, int) {
    ws = smem;
    bs = ws + num_buckets;
    doff = bs + kWin;
    Mp = (M + kBM - 1) / kBM * kBM;
    if (!table) return;
    for (int t = threadIdx.x; t < num_buckets; t += kThreads)
      ws[t] = table[t * H + h];
    if (dw_part)
      for (int t = threadIdx.x; t < n_off(M); t += kThreads) doff[t] = 0.f;
  }
  // offsets j0 - i0 - (kBM - 1) .. j0 - i0 + kBN - 1; those outside
  // [-(M - 1), N - 1] only meet masked scores and are clamped
  __device__ void stage(int i0, int j0, int M, int N) {
    if (!table) return;
    for (int t = threadIdx.x; t < kWin; t += kThreads) {
      int gi = j0 - i0 - (kBM - 1) + t + M - 1;
      gi = max(0, min(gi, M + N - 2));
      bs[t] = ws[bucket[gi]];
    }
  }
  __device__ float at(int ii, int jj) const {
    return table ? bs[jj - ii + kBM - 1] : 0.f;
  }
  __device__ bool keeps_ds() const { return dw_part != nullptr; }
  __device__ void skip(int, int, int, int) {}
  // thread t sums diagonal t (jj - ii = t - (kBM - 1)) of the tile, in row
  // order, into its offset's slot
  __device__ void sink(const float* ds_s, int i0, int, int, int) {
    for (int t = threadIdx.x; t < kWin; t += kThreads) {
      const int d0 = t - (kBM - 1);
      float acc = 0.f;
      for (int ii = max(0, -d0); ii < kBM && ii + d0 < kBN; ++ii)
        acc += ds_s[ii * kLd + ii + d0];
      doff[d0 - i0 + Mp - 1] += acc;
    }
  }
  // per-offset sums into buckets: `parts` threads per bucket each scan a
  // contiguous share of the offsets, then one thread adds the shares in
  // order
  __device__ void finish(float* scratch, size_t bh, int j0, int M, int N) {
    if (!dw_part) return;
    const int tid = threadIdx.x;
    const int n = n_off(M);
    __syncthreads();  // the last tile's sums are in doff
    const int parts = kThreads / num_buckets;
    const int nb = tid / parts, part = tid - nb * parts;
    if (nb < num_buckets) {
      const int chunk = (n + parts - 1) / parts;
      const int e_end = min(n, (part + 1) * chunk);
      float acc = 0.f;
      for (int e = part * chunk; e < e_end; ++e) {
        const int gi = e - (Mp - 1) + j0 + M - 1;  // bucket index of offset
        if (gi >= 0 && gi <= M + N - 2 && bucket[gi] == nb) acc += doff[e];
      }
      scratch[tid] = acc;
    }
    __syncthreads();
    if (tid < num_buckets) {
      float acc = 0.f;
      for (int p = 0; p < parts; ++p) acc += scratch[tid * parts + p];
      dw_part[(bh * gridDim.x + blockIdx.x) * num_buckets + tid] = acc;
    }
  }
};

template <int D>
constexpr int fwd_smem_floats() {
  return kBN * (D + 1) + kBN * D + kBM * kLd;
}
template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * kBM * D + 2 * kBM + kBM * kLd;
}
template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBN * D;
}

template <typename T, int D, typename Bias>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, Bias bias, T* __restrict__ o,
           float* __restrict__ lse, int H, int M, int N, float sm_scale,
           int causal) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBN x (D + 1)
  float* vs = ks + kBN * (D + 1);               // kBN x D
  float* ps = vs + kBN * D;                     // kBM x kLd
  const int tid = threadIdx.x;
  const int r = tid >> 2;                       // query row inside the tile
  const int sub = tid & 3;                      // which quarter of the row
  const int i0 = blockIdx.x * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int row = i0 + r;
  const bool row_ok = row < M;
  const int offset = N - M;                     // bottom-right causal alignment
  bias.init(ps + kBM * kLd, b, h, H, M, N);

  float qr[D];
  const T* qrow = q + (bh * M + (row_ok ? row : 0)) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = row_ok ? to_float(qrow[d]) : 0.f;

  float acc[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) acc[e] = 0.f;
  float m_i = kNegInf, l_i = 0.f;

  int n_end = N;
  if (causal) n_end = min(N, i0 + kBM + offset);
  const T* kb = k + bh * N * D;
  const T* vb = v + bh * N * D;

  for (int j0 = 0; j0 < n_end; j0 += kBN) {
    __syncthreads();  // the previous tile's readers are done (init is too)
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int jj = idx / D, dd = idx - jj * D;
      const int col = j0 + jj;
      float kv = 0.f, vv = 0.f;
      if (col < N) {
        kv = to_float(kb[static_cast<size_t>(col) * D + dd]);
        vv = to_float(vb[static_cast<size_t>(col) * D + dd]);
      }
      ks[jj * (D + 1) + dd] = kv;
      vs[jj * D + dd] = vv;
    }
    bias.stage(i0, j0, M, N);
    __syncthreads();

    float s[kBN / 4];
    unsigned live = 0;
    float mt = kNegInf;
#pragma unroll
    for (int c = 0; c < kBN / 4; ++c) {
      const int jj = sub + 4 * c;
      const int col = j0 + jj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qr[d] * ks[jj * (D + 1) + d];
      const bool ok = row_ok && col < N && (!causal || col <= row + offset);
      s[c] = ok ? dot * sm_scale + bias.at(r, jj) : kNegInf;
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
      ps[r * kLd + sub + 4 * c] = round_to<T>(p);
    }
    psum = row_sum(psum);
    l_i = l_i * alpha + psum;
    m_i = m_new;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) acc[e] *= alpha;
    __syncthreads();  // P of all four quarters of every row is written
#pragma unroll 4
    for (int jj = 0; jj < kBN; ++jj) {
      const float p = ps[r * kLd + jj];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) acc[e] += p * vs[jj * D + sub + 4 * e];
    }
  }

  if (!row_ok) return;
  const float l_safe = l_i > 0.f ? l_i : 1.f;
  T* orow = o + (bh * M + row) * D;
#pragma unroll
  for (int e = 0; e < D / 4; ++e)
    orow[sub + 4 * e] = from_float<T>(acc[e] / l_safe);
  if (sub == 0) lse[bh * M + row] = l_i > 0.f ? m_i + logf(l_safe) : kNegInf;
}

template <typename T, int D, typename Bias>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            Bias bias, T* __restrict__ dk, T* __restrict__ dv, int H, int M,
            int N, float sm_scale, int causal) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBM x D
  float* dos = qs + kBM * D;                    // kBM x D
  float* lse_s = dos + kBM * D;                 // kBM
  float* delta_s = lse_s + kBM;                 // kBM
  float* ds_s = delta_s + kBM;                  // kBM x kLd: the tile's dS
  const int tid = threadIdx.x;
  const int jj = tid >> 2;  // key inside the tile
  const int sub = tid & 3;
  const int j0 = blockIdx.x * kBN;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int col = j0 + jj;
  const bool col_ok = col < N;
  const int offset = N - M;  // bottom-right causal alignment
  bias.init(ds_s + kBM * kLd, b, h, H, M, N);

  float kr[D / 4], vr[D / 4], dkr[D / 4], dvr[D / 4];
  const size_t krow = (bh * N + (col_ok ? col : 0)) * D;
  load_part<T, D>(k + krow, col_ok, sub, kr);
  load_part<T, D>(v + krow, col_ok, sub, vr);
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dkr[e] = dvr[e] = 0.f;

  // the first query tile with a row that sees a key of this tile
  const int i_begin = causal ? max(0, j0 - offset) / kBM * kBM : 0;
  const bool keep_ds = bias.keeps_ds();
  bias.skip(i_begin, j0, M, N);
  for (int i0 = i_begin; i0 < M; i0 += kBM) {
    __syncthreads();  // the previous tile's readers are done (init is too)
    for (int idx = tid; idx < kBM * D; idx += kThreads) {
      const int ii = idx / D;
      const int row = i0 + ii;
      const size_t g = (bh * M + row) * D + (idx - ii * D);
      qs[idx] = row < M ? to_float(q[g]) : 0.f;
      dos[idx] = row < M ? to_float(dout[g]) : 0.f;
    }
    for (int t = tid; t < kBM; t += kThreads) {
      const int row = i0 + t;
      lse_s[t] = row < M ? lse[bh * M + row] : kNegInf;
      delta_s[t] = row < M ? delta[bh * M + row] : 0.f;
    }
    bias.stage(i0, j0, M, N);
    __syncthreads();

    for (int ii = 0; ii < kBM; ++ii) {
      const int row = i0 + ii;
      const float s = row_sum(dot_part<D>(qs + ii * D, kr, sub));
      const float dp = row_sum(dot_part<D>(dos + ii * D, vr, sub));
      const float l = lse_s[ii];
      const bool ok = col_ok && row < M && l > kNegInf / 2 &&
                      (!causal || col <= row + offset);
      float p = 0.f, ds = 0.f;
      if (ok) {
        p = expf(s * sm_scale + bias.at(ii, jj) - l);
        ds = p * (dp - delta_s[ii]);
      }
      axpy_part<D>(round_to<T>(p), dos + ii * D, sub, dvr);
      axpy_part<D>(round_to<T>(ds), qs + ii * D, sub, dkr);
      if (keep_ds && sub == 0) ds_s[ii * kLd + jj] = ds;
    }
    if (keep_ds) {
      __syncthreads();  // dS of the whole tile is in ds_s
      bias.sink(ds_s, i0, j0, M, N);
    }
  }

  if (col_ok) {
    const size_t orow = (bh * N + col) * D;
    store_part<T, D>(dk + orow, sub, dkr, sm_scale);
    store_part<T, D>(dv + orow, sub, dvr, 1.f);
  }
  bias.finish(ds_s, bh, j0, M, N);
}

template <typename T, int D, typename Bias>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          Bias bias, T* __restrict__ dq, int H, int M, int N, float sm_scale,
          int causal) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // kBN x D
  float* vs = ks + kBN * D;                     // kBN x D
  const int tid = threadIdx.x;
  const int ii = tid >> 2;  // query row inside the tile
  const int sub = tid & 3;
  const int i0 = blockIdx.x * kBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int row = i0 + ii;
  const bool row_ok = row < M;
  const int offset = N - M;
  bias.init(vs + kBN * D, b, h, H, M, N);

  float qr[D / 4], dor[D / 4], dqr[D / 4];
  const size_t qrow = (bh * M + (row_ok ? row : 0)) * D;
  load_part<T, D>(q + qrow, row_ok, sub, qr);
  load_part<T, D>(dout + qrow, row_ok, sub, dor);
#pragma unroll
  for (int e = 0; e < D / 4; ++e) dqr[e] = 0.f;
  const float l = row_ok ? lse[bh * M + row] : kNegInf;
  const float dl = row_ok ? delta[bh * M + row] : 0.f;

  int n_end = N;
  if (causal) n_end = min(N, i0 + kBM + offset);
  const T* kb = k + bh * N * D;
  const T* vb = v + bh * N * D;
  for (int j0 = 0; j0 < n_end; j0 += kBN) {
    __syncthreads();  // the previous tile's readers are done (init is too)
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int c = j0 + idx / D;
      const size_t g = static_cast<size_t>(j0) * D + idx;
      ks[idx] = c < N ? to_float(kb[g]) : 0.f;
      vs[idx] = c < N ? to_float(vb[g]) : 0.f;
    }
    bias.stage(i0, j0, M, N);
    __syncthreads();

    for (int jj = 0; jj < kBN; ++jj) {
      const int col = j0 + jj;
      const float s = row_sum(dot_part<D>(ks + jj * D, qr, sub));
      const float dp = row_sum(dot_part<D>(vs + jj * D, dor, sub));
      const bool ok = row_ok && col < N && l > kNegInf / 2 &&
                      (!causal || col <= row + offset);
      float ds = 0.f;
      if (ok) ds = expf(s * sm_scale + bias.at(ii, jj) - l) * (dp - dl);
      axpy_part<D>(round_to<T>(ds), ks + jj * D, sub, dqr);
    }
  }
  if (row_ok) store_part<T, D>(dq + qrow, sub, dqr, sm_scale);
}

// kernel<<<grid, kThreads, smem floats, stream>>>(args...), with the dynamic
// shared memory it needs allowed first
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int smem_floats,
                   void* stream, Args... args) {
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return cudaGetLastError();
}

template <typename T>
struct Type {
  using type = T;
};
template <int D>
using Dim = std::integral_constant<int, D>;

// f(Type<T>{}, Dim<D>{}) for the storage type and head dim of the call
template <typename F>
cudaError_t dispatch(int dtype, int D, F f) {
  auto by_dim = [&](auto t) -> cudaError_t {
    switch (D) {
      case 32: return f(t, Dim<32>{});
      case 64: return f(t, Dim<64>{});
      case 128: return f(t, Dim<128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == kFloat32) return by_dim(Type<float>{});
  if (dtype == kBFloat16) return by_dim(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// grids: one CTA per query tile (fwd, dq) or key tile (dkdv), head, batch
inline dim3 query_grid(int B, int H, int M) {
  return dim3((M + kBM - 1) / kBM, H, B);
}
inline dim3 key_grid(int B, int H, int N) {
  return dim3((N + kBN - 1) / kBN, H, B);
}

}  // namespace attn
}  // namespace ft5
