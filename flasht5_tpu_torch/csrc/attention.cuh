// The flash attention kernels of the port, written once and instantiated on a
// bias source: the forward (flash_attention_rpe.cu, flash_attention_bias.cu)
// and the backward's dK/dV and dQ kernels (flash_attention_bwd.cu,
// flash_attention_bias.cu). bf16 inputs take the tensor-core forms, f32
// inputs the CUDA-core forms (the port uses no TF32).
//
// - fwd_mma (bf16): one CTA per (128-row query tile, head, batch), 8 warps
//   of 16 query rows (FlashAttention-2's layout). Q lives in registers as
//   mma.sync A fragments (ldmatrix once); K/V tiles of 64 keys, and the bias
//   tile where the source stages one, run through a 2-stage cp.async ring;
//   S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> f32 (mma.cuh), the
//   online softmax runs on the S accumulator in f32, and P goes from that
//   accumulator to PV's A fragments in registers, never through shared
//   memory.
// - dkdv_mma (bf16): one CTA per (64-key tile, head, batch), 4 warps of 16
//   keys. K and V tiles stay in shared memory; Q, dO, lse and delta tiles of
//   64 query rows (and the bias tile) stream through a 2-stage cp.async
//   ring. Each warp computes S^T = K Q^T and dP^T = V dO^T on mma.sync,
//   forms P^T = exp(s^T * scale + bias - lse) and dS^T = P^T (dP^T - delta)
//   in f32 on the accumulators, rounds them to bf16 straight into A
//   fragments, and accumulates dV += P^T dO and dK += dS^T Q in f32
//   registers (B read by ldmatrix.trans from the staged tiles). A source
//   that keeps dS gets it through a 64 x 68 f32 tile in shared memory.
// - dq_mma (bf16): the forward's layout (128 query rows, 8 warps of 16) with
//   one more product: S = Q K^T and dP = dO V^T from Q and dO fragments held
//   in registers, dS in f32 on the accumulators, dQ += dS K, K and V tiles
//   (and the bias tile) through the 2-stage ring.
// - fwd, dkdv, dq (f32 inputs): the CUDA-core forms, four threads per query
//   or key row, 64-row tiles in shared memory, sums in fp32.
//
// Causal masking is bottom-right aligned; rows with no visible key (lse =
// -1e30) contribute nothing; the forward writes o = 0 and lse = -1e30 for
// them. Scores are s * scale + bias in fp32, the TPU kernels' order.
//
// Rounding points mirror the TPU kernels: scores, P, dP and dS in fp32; P
// rounded to the input type before the PV and P^T dO products, dS rounded to
// it before the dS^T q and dS k products, sums in fp32, each output rounded
// once (dQ and dK after the scale). The bf16 products on the tensor cores
// are exact in f32 and summed in f32, as on the CUDA cores, so the two forms
// differ only in the order of f32 sums.
//
// Bound on the H100: the backward does 10 B H M N D flops in bf16 (S, dP
// and the three gradient products: 5 of the forward's 2 B H M N D), bound
// by operations at the encoder's shape (0.0434 ms at 989 TFLOP/s for B 8,
// H 8, M = N = 1024, D 64) and by bytes at short ones. mma.sync reaches
// about two thirds of the card's wgmma rate; wgmma with a TMA producer
// (FlashAttention-3's layout) is the next step.
//
// A bias source `Bias` is a struct passed by value to the kernels:
//   smem_floats(M)            floats of shared memory it takes (host side)
//   init(smem, b, h, H, M, N) once per CTA, before the first tile
//   stage(i0, j0, M, N, buf)  the bias of the tile pair at query rows i0..,
//                             keys j0.. into shared-memory buffer buf (the
//                             kernel syncs, and waits for its cp.async
//                             copies, before reading it)
//   at(ii, jj, buf)           the bias of row i0 + ii, key j0 + jj
//   pair(ii, jj, buf)         fwd_mma: at(ii, jj) and at(ii, jj + 1), at
//                             accumulator-fragment coordinates
//   keeps_ds()                whether the dK/dV kernel hands it dS (host
//                             side too: it sizes the dS tile)
//   skip(i_begin, j0, M, N)   dK/dV: the rows above i_begin, which a causal
//                             mask keeps from every key of the tile (dS 0)
//   sink(ds_s, ld, i0, j0, M, N)  dK/dV: the tile pair's dS, in ds_s with
//                             row stride ld, after a sync
//   finish(scratch, bh, j0, M, N)  dK/dV: after the last tile; scratch is
//                             the dS tile (at least 256 floats), free again
// TableBias below reads the T5 bucket table; flash_attention_bias.cu has the
// bias tensor's source.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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
constexpr int kFwdBM = 128;          // query rows per CTA of fwd_mma_kernel
constexpr int kFwdThreads = kFwdBM * 2;  // a warp per 16 rows
constexpr int kBwdThreads = kBN * 2;     // dkdv_mma_kernel: a warp per 16 keys
constexpr int kDsLd = kBN + 4;           // row stride of dkdv_mma's dS tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The T5 bias read from the (num_buckets, H) bucket table through the
// (M + N - 1,) int32 bucket of every offset col - row (bucket[col - row +
// M - 1], computed on the CPU, so no log is evaluated here); no bias when
// the table is null. Each tile pair (BM query rows, kBN keys) stages the
// (BM + kBN - 1)-entry window of the offsets it spans, into one of NBUF
// buffers (two for fwd_mma_kernel, which stages the next tile's window
// while it reads this one's). With dw_part, the dK/dV kernel sums dS along each
// diagonal (one offset) of every tile into shared memory and, at the end,
// those per-offset sums into one row of num_buckets floats per CTA through
// the bucket of each offset; the wrapper sums those rows in a fixed order,
// so dW is deterministic without global float atomics. NT: the kernel's
// threads.
template <int BM, int NBUF, int NT>
struct TableBiasT {
  static constexpr int kW = BM + kBN - 1;
  const float* table;  // (num_buckets, H) f32, or null
  const int* bucket;   // (M + N - 1,) int32
  int num_buckets;     // 0 without a table
  float* dw_part;      // (B, H, ceil(N / kBN), num_buckets) f32, or null
  float* ws;           // shared: table[:, h]
  float* bs;           // shared: NBUF bias windows of kW entries
  float* doff;         // shared: sums of dS by offset (dK/dV)
  int Mp;              // M rounded up to BM; doff[e] holds offset
                       // e - (Mp - 1) + j0

  static __host__ __device__ int n_off(int M) {
    return (M + BM - 1) / BM * BM + kBN - 1;
  }
  __host__ int smem_floats(int M) const {
    return table ? num_buckets + NBUF * kW + (dw_part ? n_off(M) : 0) : 0;
  }
  __device__ void init(float* smem, int, int h, int H, int M, int) {
    ws = smem;
    bs = ws + num_buckets;
    doff = bs + NBUF * kW;
    Mp = (M + BM - 1) / BM * BM;
    if (!table) return;
    for (int t = threadIdx.x; t < num_buckets; t += NT)
      ws[t] = table[t * H + h];
    if (dw_part)
      for (int t = threadIdx.x; t < n_off(M); t += NT) doff[t] = 0.f;
  }
  // offsets j0 - i0 - (BM - 1) .. j0 - i0 + kBN - 1; those outside
  // [-(M - 1), N - 1] only meet masked scores and are clamped
  __device__ void stage(int i0, int j0, int M, int N, int buf = 0) {
    if (!table) return;
    for (int t = threadIdx.x; t < kW; t += NT) {
      int gi = j0 - i0 - (BM - 1) + t + M - 1;
      gi = max(0, min(gi, M + N - 2));
      bs[buf * kW + t] = ws[bucket[gi]];
    }
  }
  __device__ float at(int ii, int jj, int buf = 0) const {
    return table ? bs[buf * kW + jj - ii + BM - 1] : 0.f;
  }
  // the bias of keys jj and jj + 1 of row ii
  __device__ float2 pair(int ii, int jj, int buf) const {
    if (!table) return make_float2(0.f, 0.f);
    const float* w = bs + buf * kW + jj - ii + BM - 1;
    return make_float2(w[0], w[1]);
  }
  __host__ __device__ bool keeps_ds() const { return dw_part != nullptr; }
  __device__ void skip(int, int, int, int) {}
  // thread t sums diagonal t (jj - ii = t - (BM - 1)) of the tile, in row
  // order, into its offset's slot
  __device__ void sink(const float* ds_s, int ld, int i0, int, int, int) {
    for (int t = threadIdx.x; t < kW; t += NT) {
      const int d0 = t - (BM - 1);
      float acc = 0.f;
      for (int ii = max(0, -d0); ii < BM && ii + d0 < kBN; ++ii)
        acc += ds_s[ii * ld + ii + d0];
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
    const int parts = max(1, NT / num_buckets);
    for (int idx = tid; idx < num_buckets * parts; idx += NT) {
      const int nb = idx / parts, part = idx - nb * parts;
      const int chunk = (n + parts - 1) / parts;
      const int e_end = min(n, (part + 1) * chunk);
      float acc = 0.f;
      for (int e = part * chunk; e < e_end; ++e) {
        const int gi = e - (Mp - 1) + j0 + M - 1;  // bucket index of offset
        if (gi >= 0 && gi <= M + N - 2 && bucket[gi] == nb) acc += doff[e];
      }
      scratch[idx] = acc;
    }
    __syncthreads();
    for (int nb = tid; nb < num_buckets; nb += NT) {
      float acc = 0.f;
      for (int p = 0; p < parts; ++p) acc += scratch[nb * parts + p];
      dw_part[(bh * gridDim.x + blockIdx.x) * num_buckets + nb] = acc;
    }
  }
};

// the f32 kernels' (64-row tiles, one buffer)
using TableBias = TableBiasT<kBM, 1, kThreads>;
// the tensor-core forward's and dQ kernel's (128-row tiles, two buffers)
using TableBiasFwd = TableBiasT<kFwdBM, 2, kFwdThreads>;
// the tensor-core dK/dV kernel's (64-row tiles, two buffers)
using TableBiasBwd = TableBiasT<kBM, 2, kBwdThreads>;

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

// The bf16 forward on the tensor cores (FlashAttention-2's layout): one
// CTA per (kFwdBM = 128 query rows, head, batch), 8 warps of 16 rows. Q is
// staged once and kept in registers as mma.sync A fragments; K and V tiles
// of kBN = 64 keys, and the bias tile where the source stages one, run
// through a 2-stage cp.async ring (the next tile loads while this one is
// used). S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> f32, the
// online softmax works on the S accumulator in f32, and P goes from the S
// accumulator to the A fragments of PV in registers, rounded to bf16. The
// bias source is asked for `pair(ii, jj, buf)`, the bias of keys jj and
// jj + 1 of row ii, at accumulator coordinates.
template <int D>
constexpr int fwd_mma_tile_bytes() {
  return (kFwdBM + 4 * kBN) * (D + 8) * 2;   // Q, and K and V twice
}

// rows [r0, r0 + R) of a (n_rows, D) bf16 array into a tile of row stride
// D + 8, by 16-byte cp.async from NT threads; rows past n_rows are
// zero-filled
template <int R, int D, int NT = kFwdThreads>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n_rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += NT) {
    const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
    const int row = r0 + r;
    const bool ok = row < n_rows;
    mma::cp_async16(dst + r * (D + 8) + c,
                    src + static_cast<size_t>(ok ? row : 0) * D + c,
                    ok ? 16 : 0);
  }
}

template <int D, typename Bias>
__global__ void __launch_bounds__(kFwdThreads)
fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, Bias bias,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
               int M, int N, float sm_scale, int causal) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;      // 16-byte pad: ldmatrix rows hit distinct
                                  // banks
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);    // kFwdBM x kLd
  bf16* ks = qs + kFwdBM * kLd;                 // 2 x kBN x kLd
  bf16* vs = ks + 2 * kBN * kLd;                // 2 x kBN x kLd
  float* bias_smem = reinterpret_cast<float*>(vs + 2 * kBN * kLd);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;                     // the warp's first row
  const int i0 = blockIdx.x * kFwdBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int offset = N - M;                     // bottom-right causal
  bias.init(bias_smem, b, h, H, M, N);
  __syncthreads();                              // the bias source's table

  int n_end = N;
  if (causal) n_end = max(0, min(N, i0 + kFwdBM + offset));
  const int n_tiles = (n_end + kBN - 1) / kBN;
  const bf16* kb = k + bh * N * D;
  const bf16* vb = v + bh * N * D;
  auto stage = [&](int t) {       // tile t's K, V and bias into buffer t & 1
    const int buf = t & 1;
    load_rows_async<kBN, D>(ks + buf * kBN * kLd, kb, t * kBN, N);
    load_rows_async<kBN, D>(vs + buf * kBN * kLd, vb, t * kBN, N);
    bias.stage(i0, t * kBN, M, N, buf);
  };
  load_rows_async<kFwdBM, D>(qs, q + bh * M * D, i0, M);
  if (n_tiles > 0) stage(0);
  mma::cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, j0 = t * kBN;
    if (t + 1 < n_tiles) {
      stage(t + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();              // tile t (and Q) in shared memory for all
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma::ldsm_x4(qf[kk], qs + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                      kLd + 16 * kk + 8 * (lane >> 4));
    }
    const bf16* kt = ks + buf * kBN * kLd;
    const bf16* vt = vs + buf * kBN * kLd;

    // S = Q K^T: s[j][2h + e] is row wr + g + 8h, key j0 + 8j + 2tq + e
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < kBN / 8; j += 2) {
        uint32_t bfr[4];
        mma::ldsm_x4(bfr, kt + (8 * j + (lane & 7) + 8 * (lane >> 4)) * kLd +
                              16 * kk + 8 * ((lane >> 3) & 1));
        mma::mma_bf16_16816(s[j], qf[kk], bfr);
        mma::mma_bf16_16816(s[j + 1], qf[kk], bfr + 2);
      }

    // scores, masks and the online softmax, row by row (hh), in log2
    // units (x log2(e)) so that each exponential is one ex2; only a tile
    // at the keys' end or, causal, on the warp's diagonal masks (rows past
    // M are computed on zero queries and never stored)
    const bool edge = j0 + kBN > N ||
                      (causal && j0 + kBN - 1 > i0 + wr + offset);
    uint32_t live = 0xffffffffu;  // bit 4j + 2h + e: the score is visible
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ii = wr + g + 8 * hh, row = i0 + ii;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int jj = 8 * j + 2 * tq;
        const float2 bv = bias.pair(ii, jj, buf);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = (s[j][2 * hh + e] * sm_scale + (e ? bv.y : bv.x)) *
                    kLog2e;
          if (edge) {
            const int col = j0 + jj + e;
            const bool ok = col < N && (!causal || col <= row + offset);
            x = ok ? x : kNegInf;
            live &= ~(static_cast<uint32_t>(!ok) << (4 * j + 2 * hh + e));
          }
          s[j][2 * hh + e] = x;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_i[hh], mt);
      const float alpha = exp2f(m_i[hh] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(s[j][2 * hh + e] - m_new);
          if (edge) p = ((live >> (4 * j + 2 * hh + e)) & 1u) ? p : 0.f;
          s[j][2 * hh + e] = p;
          psum += p;
        }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_i[hh] = l_i[hh] * alpha + psum;
      m_i[hh] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 into the A fragments of each 16 keys
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t bfr[4];
        mma::ldsm_x4_t(bfr, vt + (16 * kk + (lane & 7) +
                                  8 * ((lane >> 3) & 1)) * kLd +
                                 8 * j + 8 * (lane >> 4));
        mma::mma_bf16_16816(acc[j], pa, bfr);
        mma::mma_bf16_16816(acc[j + 1], pa, bfr + 2);
      }
    }
    __syncthreads();              // buffer `buf` is free for tile t + 2
  }
  mma::cp_async_wait<0>();        // (no tile: only Q was in flight)

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + wr + g + 8 * hh;
    if (row >= M) continue;
    const float l_safe = l_i[hh] > 0.f ? l_i[hh] : 1.f;
    bf16* orow = o + (bh * M + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
          mma::pack_bf16(acc[j][2 * hh] / l_safe,
                         acc[j][2 * hh + 1] / l_safe);
    if (tq == 0)   // m_i in log2 units
      lse[bh * M + row] =
          l_i[hh] > 0.f ? m_i[hh] * kLn2 + logf(l_safe) : kNegInf;
  }
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
      bias.sink(ds_s, kLd, i0, j0, M, N);
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

// The bf16 backward on the tensor cores. dkdv_mma_kernel: one CTA per
// (kBN = 64 keys, head, batch), 4 warps of 16 keys; K and V tiles are
// staged once, and the Q, dO, lse and delta tiles of 64 query rows (and the
// bias tile where the source stages one) run through a 2-stage cp.async
// ring. Per block of kQS query rows a warp computes S^T = K Q^T and dP^T =
// V dO^T (mma.sync m16n8k16; A by ldmatrix from the K/V tiles, B from the
// Q/dO tiles), then P^T and dS^T in f32 on the accumulators (the bias source
// is asked for `at(query, key)` there), and rounds them to bf16 straight
// into the A fragments of dV += P^T dO and dK += dS^T Q (B by
// ldmatrix.trans). A source that keeps dS is handed the tile's dS through a
// kBM x kDsLd f32 tile (68: the accumulator's (query 2 tq + e, key g)
// writes fall in distinct banks).
template <int D>
constexpr int dkdv_mma_tile_bytes() {
  return (2 * kBN + 4 * kBM) * (D + 8) * 2 + 4 * kBM * 4;
}

template <int D, typename Bias>
__global__ void __launch_bounds__(kBwdThreads)
dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, Bias bias,
                __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int H, int M, int N,
                float sm_scale, int causal) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;
  constexpr int kQS = D <= 64 ? 64 : 32;   // query rows per S^T block
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);    // kBN x kLd
  bf16* vs = ks + kBN * kLd;                    // kBN x kLd
  bf16* qs = vs + kBN * kLd;                    // 2 x kBM x kLd
  bf16* dos = qs + 2 * kBM * kLd;               // 2 x kBM x kLd
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kBM * kLd);  // 2 x kBM
  float* delta_s = lse_s + 2 * kBM;             // 2 x kBM
  float* ds_s = delta_s + 2 * kBM;              // kBM x kDsLd, if kept
  const bool keep_ds = bias.keeps_ds();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wk = warp * 16;                     // the warp's first key
  const int j0 = blockIdx.x * kBN;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int offset = N - M;                     // bottom-right causal
  bias.init(ds_s + (keep_ds ? kBM * kDsLd : 0), b, h, H, M, N);
  __syncthreads();                              // the bias source's table

  // the first query tile with a row that sees a key of this tile
  const int i_begin = causal ? max(0, j0 - offset) / kBM * kBM : 0;
  const int n_tiles = i_begin < M ? (M - i_begin + kBM - 1) / kBM : 0;
  bias.skip(i_begin, j0, M, N);
  const bf16* qb = q + bh * M * D;
  const bf16* dob = dout + bh * M * D;
  auto stage = [&](int t) {       // query tile t into buffer t & 1
    const int buf = t & 1, i0 = i_begin + t * kBM;
    load_rows_async<kBM, D, kBwdThreads>(qs + buf * kBM * kLd, qb, i0, M);
    load_rows_async<kBM, D, kBwdThreads>(dos + buf * kBM * kLd, dob, i0, M);
    for (int r = tid; r < kBM; r += kBwdThreads) {
      const int row = i0 + r;
      lse_s[buf * kBM + r] = row < M ? lse[bh * M + row] : kNegInf;
      delta_s[buf * kBM + r] = row < M ? delta[bh * M + row] : 0.f;
    }
    bias.stage(i0, j0, M, N, buf);
  };
  load_rows_async<kBN, D, kBwdThreads>(ks, k + bh * N * D, j0, N);
  load_rows_async<kBN, D, kBwdThreads>(vs, v + bh * N * D, j0, N);
  if (n_tiles > 0) stage(0);
  mma::cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, i0 = i_begin + t * kBM;
    if (t + 1 < n_tiles) {
      stage(t + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();              // tile t (and K, V) in shared memory
    const bf16* qt = qs + buf * kBM * kLd;
    const bf16* dot = dos + buf * kBM * kLd;
    const float* lt = lse_s + buf * kBM;
    const float* dlt = delta_s + buf * kBM;
    // only a tile at the keys' end or crossing the causal diagonal masks
    // single scores (a row past M has lse -1e30 and is masked whole)
    const bool edge = j0 + kBN > N || (causal && j0 + kBN - 1 > i0 + offset);

#pragma unroll
    for (int q0 = 0; q0 < kBM; q0 += kQS) {
      // S^T = K Q^T, dP^T = V dO^T: st[j][2hh + e] is key wk + g + 8hh,
      // query row q0 + 8j + 2tq + e of the tile
      float st[kQS / 8][4], dpt[kQS / 8][4];
#pragma unroll
      for (int j = 0; j < kQS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        const int a_off = (wk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                          16 * kk + 8 * (lane >> 4);
        mma::ldsm_x4(kf, ks + a_off);
        mma::ldsm_x4(vf, vs + a_off);
#pragma unroll
        for (int j = 0; j < kQS / 8; j += 2) {
          uint32_t bq[4], bo[4];
          const int b_off = (q0 + 8 * j + (lane & 7) + 8 * (lane >> 4)) * kLd +
                            16 * kk + 8 * ((lane >> 3) & 1);
          mma::ldsm_x4(bq, qt + b_off);
          mma::ldsm_x4(bo, dot + b_off);
          mma::mma_bf16_16816(st[j], kf, bq);
          mma::mma_bf16_16816(st[j + 1], kf, bq + 2);
          mma::mma_bf16_16816(dpt[j], vf, bo);
          mma::mma_bf16_16816(dpt[j + 1], vf, bo + 2);
        }
      }
      // P^T = exp(s^T * scale + bias - lse), dS^T = P^T (dP^T - delta), f32
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int jj = wk + g + 8 * hh, col = j0 + jj;
#pragma unroll
        for (int j = 0; j < kQS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ii = q0 + 8 * j + 2 * tq + e, row = i0 + ii;
            const float l = lt[ii];
            bool ok = l > kNegInf / 2;
            if (edge) ok = ok && col < N && (!causal || col <= row + offset);
            float p = 0.f, ds = 0.f;
            if (ok) {
              p = expf(st[j][2 * hh + e] * sm_scale + bias.at(ii, jj, buf) -
                       l);
              ds = p * (dpt[j][2 * hh + e] - dlt[ii]);
            }
            st[j][2 * hh + e] = p;
            dpt[j][2 * hh + e] = ds;
            if (keep_ds) ds_s[ii * kDsLd + jj] = ds;
          }
      }
      // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16 into the A
      // fragments of each 16 query rows
#pragma unroll
      for (int kc = 0; kc < kQS / 16; ++kc) {
        uint32_t pa[4], da[4];
        pa[0] = mma::pack_bf16(st[2 * kc][0], st[2 * kc][1]);
        pa[1] = mma::pack_bf16(st[2 * kc][2], st[2 * kc][3]);
        pa[2] = mma::pack_bf16(st[2 * kc + 1][0], st[2 * kc + 1][1]);
        pa[3] = mma::pack_bf16(st[2 * kc + 1][2], st[2 * kc + 1][3]);
        da[0] = mma::pack_bf16(dpt[2 * kc][0], dpt[2 * kc][1]);
        da[1] = mma::pack_bf16(dpt[2 * kc][2], dpt[2 * kc][3]);
        da[2] = mma::pack_bf16(dpt[2 * kc + 1][0], dpt[2 * kc + 1][1]);
        da[3] = mma::pack_bf16(dpt[2 * kc + 1][2], dpt[2 * kc + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 8; jd += 2) {
          uint32_t bo[4], bq[4];
          const int b_off =
              (q0 + 16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
              8 * jd + 8 * (lane >> 4);
          mma::ldsm_x4_t(bo, dot + b_off);
          mma::ldsm_x4_t(bq, qt + b_off);
          mma::mma_bf16_16816(dva[jd], pa, bo);
          mma::mma_bf16_16816(dva[jd + 1], pa, bo + 2);
          mma::mma_bf16_16816(dka[jd], da, bq);
          mma::mma_bf16_16816(dka[jd + 1], da, bq + 2);
        }
      }
    }
    if (keep_ds) {
      __syncthreads();            // dS of the whole tile is in ds_s
      bias.sink(ds_s, kDsLd, i0, j0, M, N);
    }
    __syncthreads();              // buffer `buf` (and ds_s) free again
  }
  mma::cp_async_wait<0>();        // (no tile: only K and V were in flight)

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = j0 + wk + g + 8 * hh;
    if (col >= N) continue;
    bf16* dkrow = dk + (bh * N + col) * D;
    bf16* dvrow = dv + (bh * N + col) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkrow + 8 * j + 2 * tq) =
          mma::pack_bf16(dka[j][2 * hh] * sm_scale,
                         dka[j][2 * hh + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dvrow + 8 * j + 2 * tq) =
          mma::pack_bf16(dva[j][2 * hh], dva[j][2 * hh + 1]);
    }
  }
  bias.finish(ds_s, bh, j0, M, N);
}

// dq_mma_kernel: the forward's layout, one CTA per (kFwdBM = 128 query
// rows, head, batch), 8 warps of 16 rows, Q and dO held in registers as A
// fragments, K and V tiles of 64 keys (and the bias tile) through a 2-stage
// cp.async ring. Per block of kKS keys: S = Q K^T and dP = dO V^T on
// mma.sync, dS = P (dP - delta) in f32 on the accumulators (the bias
// source is asked for `pair(row, key)`, as in the forward), then dQ += dS K
// with dS rounded to bf16 into A fragments.
template <int D>
constexpr int dq_mma_tile_bytes() {
  return (2 * kFwdBM + 4 * kBN) * (D + 8) * 2;  // Q, dO; K and V twice
}

template <int D, typename Bias>
__global__ void __launch_bounds__(kFwdThreads)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              Bias bias, __nv_bfloat16* __restrict__ dq, int H, int M, int N,
              float sm_scale, int causal) {
  using bf16 = __nv_bfloat16;
  constexpr int kLd = D + 8;
  constexpr int kKS = D <= 64 ? 64 : 32;   // keys per S block
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);    // kFwdBM x kLd
  bf16* dos = qs + kFwdBM * kLd;                // kFwdBM x kLd
  bf16* ks = dos + kFwdBM * kLd;                // 2 x kBN x kLd
  bf16* vs = ks + 2 * kBN * kLd;                // 2 x kBN x kLd
  float* bias_smem = reinterpret_cast<float*>(vs + 2 * kBN * kLd);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = warp * 16;                     // the warp's first row
  const int i0 = blockIdx.x * kFwdBM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int offset = N - M;                     // bottom-right causal
  bias.init(bias_smem, b, h, H, M, N);
  __syncthreads();                              // the bias source's table

  int n_end = N;
  if (causal) n_end = max(0, min(N, i0 + kFwdBM + offset));
  const int n_tiles = (n_end + kBN - 1) / kBN;
  const bf16* kb = k + bh * N * D;
  const bf16* vb = v + bh * N * D;
  auto stage = [&](int t) {       // tile t's K, V and bias into buffer t & 1
    const int buf = t & 1;
    load_rows_async<kBN, D>(ks + buf * kBN * kLd, kb, t * kBN, N);
    load_rows_async<kBN, D>(vs + buf * kBN * kLd, vb, t * kBN, N);
    bias.stage(i0, t * kBN, M, N, buf);
  };
  load_rows_async<kFwdBM, D>(qs, q + bh * M * D, i0, M);
  load_rows_async<kFwdBM, D>(dos, dout + bh * M * D, i0, M);
  if (n_tiles > 0) stage(0);
  mma::cp_async_commit();

  float l[2], dl[2];              // rows wr + g and wr + g + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + wr + g + 8 * hh;
    l[hh] = row < M ? lse[bh * M + row] : kNegInf;
    dl[hh] = row < M ? delta[bh * M + row] : 0.f;
  }
  uint32_t qf[D / 16][4], df[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, j0 = t * kBN;
    if (t + 1 < n_tiles) {
      stage(t + 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();              // tile t (and Q, dO) in shared memory
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a_off = (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                          16 * kk + 8 * (lane >> 4);
        mma::ldsm_x4(qf[kk], qs + a_off);
        mma::ldsm_x4(df[kk], dos + a_off);
      }
    }
    const bf16* kt = ks + buf * kBN * kLd;
    const bf16* vt = vs + buf * kBN * kLd;
    const bool edge = j0 + kBN > N ||
                      (causal && j0 + kBN - 1 > i0 + wr + offset);

#pragma unroll
    for (int c0 = 0; c0 < kBN; c0 += kKS) {
      // S = Q K^T, dP = dO V^T: s[j][2hh + e] is row wr + g + 8hh, key
      // c0 + 8j + 2tq + e of the tile
      float s[kKS / 8][4], dp[kKS / 8][4];
#pragma unroll
      for (int j = 0; j < kKS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < kKS / 8; j += 2) {
          uint32_t bk[4], bv[4];
          const int b_off = (c0 + 8 * j + (lane & 7) + 8 * (lane >> 4)) * kLd +
                            16 * kk + 8 * ((lane >> 3) & 1);
          mma::ldsm_x4(bk, kt + b_off);
          mma::ldsm_x4(bv, vt + b_off);
          mma::mma_bf16_16816(s[j], qf[kk], bk);
          mma::mma_bf16_16816(s[j + 1], qf[kk], bk + 2);
          mma::mma_bf16_16816(dp[j], df[kk], bv);
          mma::mma_bf16_16816(dp[j + 1], df[kk], bv + 2);
        }
      // dS = exp(s * scale + bias - lse) (dP - delta), in f32
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ii = wr + g + 8 * hh, row = i0 + ii;
#pragma unroll
        for (int j = 0; j < kKS / 8; ++j) {
          const int jj = c0 + 8 * j + 2 * tq;
          const float2 bp = bias.pair(ii, jj, buf);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j0 + jj + e;
            bool ok = l[hh] > kNegInf / 2;
            if (edge) ok = ok && col < N && (!causal || col <= row + offset);
            float ds = 0.f;
            if (ok)
              ds = expf(s[j][2 * hh + e] * sm_scale + (e ? bp.y : bp.x) -
                        l[hh]) * (dp[j][2 * hh + e] - dl[hh]);
            s[j][2 * hh + e] = ds;
          }
        }
      }
      // dQ += dS K, dS rounded to bf16 into the A fragments of each 16 keys
#pragma unroll
      for (int kc = 0; kc < kKS / 16; ++kc) {
        uint32_t da[4];
        da[0] = mma::pack_bf16(s[2 * kc][0], s[2 * kc][1]);
        da[1] = mma::pack_bf16(s[2 * kc][2], s[2 * kc][3]);
        da[2] = mma::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        da[3] = mma::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 8; jd += 2) {
          uint32_t bk[4];
          mma::ldsm_x4_t(bk, kt + (c0 + 16 * kc + (lane & 7) +
                                   8 * ((lane >> 3) & 1)) * kLd +
                                 8 * jd + 8 * (lane >> 4));
          mma::mma_bf16_16816(acc[jd], da, bk);
          mma::mma_bf16_16816(acc[jd + 1], da, bk + 2);
        }
      }
    }
    __syncthreads();              // buffer `buf` is free for tile t + 2
  }
  mma::cp_async_wait<0>();        // (no tile: only Q and dO were in flight)

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + wr + g + 8 * hh;
    if (row >= M) continue;
    bf16* dqrow = dq + (bh * M + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqrow + 8 * j + 2 * tq) =
          mma::pack_bf16(acc[j][2 * hh] * sm_scale,
                         acc[j][2 * hh + 1] * sm_scale);
  }
}

// kernel<<<grid, threads, smem floats, stream>>>(args...), with the
// dynamic shared memory it needs allowed first
template <typename... KArgs, typename... Args>
cudaError_t launch_threads(void (*kernel)(KArgs...), dim3 grid, int threads,
                           int smem_floats, void* stream, Args... args) {
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return cudaGetLastError();
}
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), dim3 grid, int smem_floats,
                   void* stream, Args... args) {
  return launch_threads(kernel, grid, kThreads, smem_floats, stream,
                        args...);
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

// The forward in either form: bf16 on the tensor cores (fwd_mma_kernel on
// the bias source `mma_bias`), f32 on the CUDA cores (fwd_kernel on
// `bias`; the port uses no TF32).
template <typename Bias, typename MmaBias>
cudaError_t launch_fwd(const Bias& bias, const MmaBias& mma_bias, int dtype,
                       const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int M, int N, int D,
                       float sm_scale, int causal, void* stream) {
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_threads(
          fwd_mma_kernel<kD, MmaBias>, dim3((M + kFwdBM - 1) / kFwdBM, H, B),
          kFwdThreads, fwd_mma_tile_bytes<kD>() / 4 + mma_bias.smem_floats(M),
          stream, tq, tk, tv, mma_bias, static_cast<T*>(o), lse, H, M, N,
          sm_scale, causal);
    else
      return launch(fwd_kernel<T, kD, Bias>, dim3((M + kBM - 1) / kBM, H, B),
                    fwd_smem_floats<kD>() + bias.smem_floats(M), stream, tq,
                    tk, tv, bias, static_cast<T*>(o), lse, H, M, N, sm_scale,
                    causal);
  });
}

// grids: one CTA per query tile (fwd, dq) or key tile (dkdv), head, batch
inline dim3 query_grid(int B, int H, int M) {
  return dim3((M + kBM - 1) / kBM, H, B);
}
inline dim3 key_grid(int B, int H, int N) {
  return dim3((N + kBN - 1) / kBN, H, B);
}

// The backward's dK/dV kernel in either form: bf16 on the tensor cores
// (dkdv_mma_kernel on the bias source `mma_bias`), f32 on the CUDA cores
// (dkdv_kernel on `bias`).
template <typename Bias, typename MmaBias>
cudaError_t launch_dkdv(const Bias& bias, const MmaBias& mma_bias, int dtype,
                        const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int H,
                        int M, int N, int D, float sm_scale, int causal,
                        void* stream) {
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_threads(
          dkdv_mma_kernel<kD, MmaBias>, key_grid(B, H, N), kBwdThreads,
          dkdv_mma_tile_bytes<kD>() / 4 +
              (mma_bias.keeps_ds() ? kBM * kDsLd : 0) +
              mma_bias.smem_floats(M),
          stream, tq, tk, tv, tdo, lse, delta, mma_bias, static_cast<T*>(dk),
          static_cast<T*>(dv), H, M, N, sm_scale, causal);
    else
      return launch(dkdv_kernel<T, kD, Bias>, key_grid(B, H, N),
                    dkdv_smem_floats<kD>() + bias.smem_floats(M), stream, tq,
                    tk, tv, tdo, lse, delta, bias, static_cast<T*>(dk),
                    static_cast<T*>(dv), H, M, N, sm_scale, causal);
  });
}

// The backward's dQ kernel in either form: bf16 on the tensor cores
// (dq_mma_kernel on `mma_bias`, the forward's tiles), f32 on the CUDA cores
// (dq_kernel on `bias`).
template <typename Bias, typename MmaBias>
cudaError_t launch_dq(const Bias& bias, const MmaBias& mma_bias, int dtype,
                      const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int M, int N, int D,
                      float sm_scale, int causal, void* stream) {
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int kD = decltype(d)::value;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tdo = static_cast<const T*>(dout);
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return launch_threads(
          dq_mma_kernel<kD, MmaBias>, dim3((M + kFwdBM - 1) / kFwdBM, H, B),
          kFwdThreads, dq_mma_tile_bytes<kD>() / 4 + mma_bias.smem_floats(M),
          stream, tq, tk, tv, tdo, lse, delta, mma_bias, static_cast<T*>(dq),
          H, M, N, sm_scale, causal);
    else
      return launch(dq_kernel<T, kD, Bias>, query_grid(B, H, M),
                    dq_smem_floats<kD>() + bias.smem_floats(M), stream, tq,
                    tk, tv, tdo, lse, delta, bias, static_cast<T*>(dq), H, M,
                    N, sm_scale, causal);
  });
}

}  // namespace attn
}  // namespace ft5
