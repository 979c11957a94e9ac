// Fused lm_head matmul + cross-entropy, forward and backward.
//
// Replaces the Pallas kernels of flasht5_tpu/ops/fused_linear_ce.py:
// _fwd_kernel (launched at :253) and _bwd_kernel (:320). As there, each
// (64 x 64) logits tile is computed from x (rows, d) and w (d, V) in f32
// (w rounded to x's dtype as it is loaded, so an f32 weight needs no cast
// pass), scaled by logit_scale, and consumed where it was made: the
// logits never reach device memory.
//
// Bound on the H100: operations. At the train step's shape (2048 rows,
// d 512, V 32768) the forward is 68.7 GFLOP and the backward three such
// products (it recomputes the logits); the bytes are x, w and the (rows,)
// vectors. Two forms, chosen by x's dtype:
//
// - bf16 activations (the train step and scoring paths): mma.sync
//   m16n8k16 bf16 -> f32 for all three products (mma.cuh), operands staged
//   through shared memory as bf16, K in steps of 32 (logits) or 64
//   (contractions);
// - f32 activations: CUDA-core f32 FMAs on 4 x 4 (logits) or 4 x 2
//   (contractions) register tiles, 256 threads a CTA (the port does not
//   use TF32, so the tensor cores have no f32 form here).
//
// Both sum exact products in f32 and differ from the plain version only in
// the order of the sums. A stage ring (cp.async or TMA) and wgmma are
// later work.
//
// The TPU grid runs its (vocab tile, row block) steps in order and carries
// sums in scratch memory between them. Here CTAs run in parallel, so:
//
// - forward: a CTA per (row block of 64, vocab split) streams the split's
//   vocab tiles and writes per-row partial (max, sum of exp, sum of
//   logits); flce_merge_kernel folds the splits into lse. The split count
//   (ft5_flce_splits) gives ~4 CTAs an SM: at the scoring batches' 256
//   label rows there are only 4 row blocks for 132 SMs. Its operands are
//   staged one K-step at a time, so it takes any d.
// - backward, no atomics, the same bits on every run: the dx kernel, a CTA
//   per (row block, vocab split, chunk of d), loops over the split's vocab
//   tiles and keeps its (64 x chunk) dx sums in registers;
//   flce_dx_merge_kernel adds the splits in order and rounds to x's dtype.
//   The dW kernel, a CTA per (vocab tile, chunk of d), loops over all row
//   blocks and keeps its (chunk x 64) dW sums in registers. Both recompute
//   their logits tiles over the whole d and form dlogits in registers
//   (probabilities, one-hot label, smoothing, z-loss), rounded to x's dtype
//   before the contraction, as the TPU kernel does (:159).
//
// Chunks of d: the register sums hold at most 512 columns of d, so a wider
// d is cut into ceil(d / 512) equal chunks (multiples of 64, the last one
// masked), one CTA each. Every chunk's CTA recomputes the logits over the
// whole d: at d 2048 each backward kernel does 4x the logits products of
// one pass (the dx and dW kernels then do 5 products' work where the
// function needs 3). That is the price of keeping the sums in registers
// and no atomics; at d <= 512 there is one chunk and nothing changes.
//
// Rows, vocab columns and d need not be multiples of the tiles: rows past
// the end read 0 and count as ignored, columns past V and d past its end
// are masked (a d that is not a multiple of 8 is loaded element by element
// instead of by 16-byte vectors).

#include <algorithm>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBR = 64, kBV = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kPad = 4;              // floats of padding per shared row
constexpr int kTargetCtas = 528;     // four CTAs for each of 132 SMs

// ---------------------------------------------------------------------------
// CUDA-core form: f32 activations and weight (the forward and merge kernels
// below, and the dx and dW kernels after dlogits)
// ---------------------------------------------------------------------------

struct Tiles {                       // one K-step of the logits product
  float xs[kBK][kBR + kPad];         // x tile, transposed: xs[k][row]
  float ws[kBK][kBV + kPad];         // w tile: ws[k][col]
};

// The (64 x 64) f32 logits tile of rows r0.., columns c0..: thread (ty,
// tx) = (tid / 16, tid % 16) gets rows ty*4 + i, columns tx*4 + j.
// kExact: d is a multiple of kBK (no mask on d).
template <bool kExact>
__device__ __forceinline__ void logits_tile(float acc[4][4],
                                            const float* __restrict__ x,
                                            const float* __restrict__ w,
                                            int r0, int c0, int rows, int d,
                                            int V, Tiles& s) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();                   // the tiles' last readers are done
#pragma unroll
    for (int e = 0; e < kBR * kBK / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int r = idx / kBK, k = idx % kBK;
      s.xs[k][r] = r0 + r < rows && (kExact || k0 + k < d)
          ? x[static_cast<size_t>(r0 + r) * d + k0 + k] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kBK * kBV / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int k = idx / kBV, c = idx % kBV;
      s.ws[k][c] = c0 + c < V && (kExact || k0 + k < d)
          ? w[static_cast<size_t>(k0 + k) * V + c0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s.xs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.ws[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// sum / max over the 16 lanes that hold one row (a half warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the vocab tiles [begin, end) of one split
__device__ __forceinline__ void split_range(int V, int splits, int split,
                                            int* begin, int* end) {
  const int n_vt = (V + kBV - 1) / kBV;
  const int per = (n_vt + splits - 1) / splits;
  *begin = min(n_vt, split * per);
  *end = min(n_vt, *begin + per);
}

template <bool kExact>
__global__ void __launch_bounds__(kThreads)
flce_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ part_m, float* __restrict__ part_se,
                float* __restrict__ part_sl, int rows, int d, int V,
                int splits, float logit_scale, int smooth) {
  __shared__ __align__(16) Tiles s;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * kBR, split = blockIdx.y;
  int t_begin, t_end;
  split_range(V, splits, split, &t_begin, &t_end);

  float m[4], se[4], sl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = ft5::kNegInf, se[i] = sl[i] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * kBV;
    float acc[4][4];
    logits_tile<kExact>(acc, x, w, r0, c0, rows, d, V, s);
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) valid[j] = c0 + tx * 4 + j < V;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = ft5::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= logit_scale;
        if (valid[j]) tmax = fmaxf(tmax, acc[i][j]);
      }
      const float m_new = fmaxf(fmaxf(m[i], row_max(tmax)), ft5::kNegInf);
      float p = 0.f, lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid[j]) {
          p += expf(acc[i][j] - m_new);
          lsum += acc[i][j];
        }
      se[i] = se[i] * expf(m[i] - m_new) + row_sum(p);
      m[i] = m_new;
      if (smooth) sl[i] += row_sum(lsum);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r < rows) {
        const size_t o = static_cast<size_t>(split) * rows + r;
        part_m[o] = m[i];
        part_se[o] = se[i];
        part_sl[o] = sl[i];
      }
    }
  }
}

// lse (and the row sum of the logits) of each row from its first `n_merge`
// splits; `stride` is the splits the partial arrays hold
__global__ void flce_merge_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_se,
                                  const float* __restrict__ part_sl,
                                  float* __restrict__ lse,
                                  float* __restrict__ total, int rows,
                                  int n_merge) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float m = ft5::kNegInf;
  for (int sp = 0; sp < n_merge; ++sp)
    m = fmaxf(m, part_m[static_cast<size_t>(sp) * rows + r]);
  float se = 0.f, sl = 0.f;
  for (int sp = 0; sp < n_merge; ++sp) {
    const size_t o = static_cast<size_t>(sp) * rows + r;
    se += part_se[o] * expf(part_m[o] - m);
    sl += part_sl[o];
  }
  lse[r] = logf(se) + m;
  total[r] = sl;
}

// ---------------------------------------------------------------------------
// backward: dlogits (both forms) and the CUDA-core dx and dW kernels
// ---------------------------------------------------------------------------

struct Grad {                        // what dlogits need beyond the logits
  const int* labels;
  const float* lse;
  const float* dloss;
  const float* dz;
  int total_classes, ignore_index, smooth;
  float logit_scale, lse_square_scale, smoothing;
};

struct RowGrad {
  int label;
  float lse, dloss, dsum;            // dsum = dloss + dz
};

__device__ __forceinline__ RowGrad row_grad(const Grad& g, int r, int rows) {
  RowGrad q{-1, 0.f, 0.f, 0.f};
  if (r < rows) {
    q.label = g.labels[r];
    q.lse = g.lse[r];
    if (q.label != g.ignore_index) {
      q.dloss = g.dloss[r];
      q.dsum = q.dloss + g.dz[r];
    }
  }
  return q;
}

// dlogits of one scaled logit, in the TPU kernel's order of operations
__device__ __forceinline__ float dlogit(const Grad& g, const RowGrad& q,
                                        float logit, int col) {
  const float probs = expf(logit - q.lse);
  const bool onehot = col == q.label;
  float ce;
  if (g.smooth)
    ce = probs - g.smoothing / static_cast<float>(g.total_classes)
         - (onehot ? 1.f - g.smoothing : 0.f);
  else
    ce = probs - (onehot ? 1.f : 0.f);
  const float zg = (2.f * g.lse_square_scale * q.lse) * probs;
  return (q.dloss * ce + q.dsum * zg) * g.logit_scale;
}

// dlogits of this thread's (4 x 4) of the tile; columns past V give 0
__device__ __forceinline__ void dlogits_tile(float acc[4][4], const Grad& g,
                                             const RowGrad q[4], int c0,
                                             int V) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx * 4 + j;
      acc[i][j] = col < V
          ? dlogit(g, q[i], acc[i][j] * g.logit_scale, col) : 0.f;
    }
}

// dx partial sums of one vocab split and one chunk of d (NC * 32 columns
// from d0 = blockIdx.z * NC * 32): thread (ty, tx) keeps rows ty*4 + i,
// columns d0 + kc*32 + tx*2 + jj of the row block. kExact: d = NC * 32,
// one chunk (d known at compile time, no mask on it).
template <int NC, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flce_dx_kernel(const float* __restrict__ x, const float* __restrict__ w,
               Grad g, float* __restrict__ dx_part, int rows, int d_arg,
               int V, int splits) {
  const int d = kExact ? NC * kBK : d_arg;
  const int d0 = kExact ? 0 : blockIdx.z * NC * kBK;
  __shared__ __align__(16) Tiles s;
  __shared__ __align__(16) float dlT[kBV][kBR + kPad];   // dlT[col][row]
  __shared__ __align__(16) float wT[kBV][kBK + kPad];    // wT[col][k]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = blockIdx.x * kBR, split = blockIdx.y;
  int t_begin, t_end;
  split_range(V, splits, split, &t_begin, &t_end);

  RowGrad q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = row_grad(g, r0 + ty * 4 + i, rows);
  float acc[NC][4][2];
#pragma unroll
  for (int kc = 0; kc < NC; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[kc][i][0] = acc[kc][i][1] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * kBV;
    float lg[4][4];
    logits_tile<kExact>(lg, x, w, r0, c0, rows, d, V, s);
    dlogits_tile(lg, g, q, c0, V);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dlT[tx * 4 + j][ty * 4 + i] = lg[i][j];
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      __syncthreads();           // dlT written; the last wT chunk read
#pragma unroll
      for (int e = 0; e < kBV * kBK / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int k = idx / kBV, c = idx % kBV;
        const int kd = d0 + kc * kBK + k;
        wT[c][k] = c0 + c < V && (kExact || kd < d)
            ? w[static_cast<size_t>(kd) * V + c0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kBV; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&dlT[c][ty * 4]);
        const float2 b = *reinterpret_cast<const float2*>(&wT[c][tx * 2]);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[kc][i][0] = fmaf(av[i], b.x, acc[kc][i][0]);
          acc[kc][i][1] = fmaf(av[i], b.y, acc[kc][i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    float* out = dx_part + (static_cast<size_t>(split) * rows + r) * d;
#pragma unroll
    for (int kc = 0; kc < NC; ++kc)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = d0 + kc * kBK + tx * 2 + jj;
        if (kExact || col < d) out[col] = acc[kc][i][jj];
      }
  }
}

// dx = the sum of the splits' partials, in split order, in x's dtype
template <typename T>
__global__ void flce_dx_merge_kernel(const float* __restrict__ dx_part,
                                     T* __restrict__ dx, size_t n,
                                     int splits) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += dx_part[sp * n + e];
    dx[e] = ft5::from_float<T>(v);
  }
}

// dW of one vocab tile and one chunk of d over all row blocks: thread
// (tk, tx) = (tid / 16, tid % 16) keeps k = d0 + kc*32 + tk*2 + kk,
// columns tx*4 + j
template <int NC, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flce_dw_kernel(const float* __restrict__ x, const float* __restrict__ w,
               Grad g, float* __restrict__ dw, int rows, int d_arg, int V) {
  const int d = kExact ? NC * kBK : d_arg;
  const int d0 = kExact ? 0 : blockIdx.y * NC * kBK;
  __shared__ __align__(16) Tiles s;
  __shared__ __align__(16) float dls[kBR][kBV + kPad];   // dls[row][col]
  __shared__ __align__(16) float xk[kBR][kBK + kPad];    // xk[row][k]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int c0 = blockIdx.x * kBV;

  float acc[NC][2][4];
#pragma unroll
  for (int kc = 0; kc < NC; ++kc)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[kc][kk][j] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kBR) {
    RowGrad q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = row_grad(g, r0 + ty * 4 + i, rows);
    float lg[4][4];
    logits_tile<kExact>(lg, x, w, r0, c0, rows, d, V, s);
    dlogits_tile(lg, g, q, c0, V);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&dls[ty * 4 + i][tx * 4]) =
          make_float4(lg[i][0], lg[i][1], lg[i][2], lg[i][3]);
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      __syncthreads();           // dls written; the last xk chunk read
#pragma unroll
      for (int e = 0; e < kBR * kBK / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int r = idx / kBK, k = idx % kBK;
        const int kd = d0 + kc * kBK + k;
        xk[r][k] = r0 + r < rows && (kExact || kd < d)
            ? x[static_cast<size_t>(r0 + r) * d + kd] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < kBR; ++r) {
        const float2 a = *reinterpret_cast<const float2*>(&xk[r][ty * 2]);
        const float4 b = *reinterpret_cast<const float4*>(&dls[r][tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[kc][0][j] = fmaf(a.x, bv[j], acc[kc][0][j]);
          acc[kc][1][j] = fmaf(a.y, bv[j], acc[kc][1][j]);
        }
      }
    }
  }
#pragma unroll
  for (int kc = 0; kc < NC; ++kc)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kd = d0 + kc * kBK + ty * 2 + kk;
      if (!kExact && kd >= d) continue;
      float* out = dw + static_cast<size_t>(kd) * V;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col < V) out[col] = acc[kc][kk][j];
      }
    }
}

// ---------------------------------------------------------------------------
// tensor-core form: bf16 activations (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------
//
// Every operand tile is staged in shared memory in its natural layout
// (rows of 64 bf16, 16-byte vector loads, an f32 weight rounded to bf16 on
// the way) and read into fragments by ldmatrix, transposed where the
// product needs it, so no thread scatters a transpose. K steps of 64.

using bf16 = __nv_bfloat16;
constexpr int kT = 64;                 // every staged tile is 64 x 64
constexpr int kTS = kT + 8;            // its row stride: 144 B, conflict-free

struct MmaTiles {                      // one K-step of the logits product
  bf16 xs[kT][kTS];                    // x[row][k]
  bf16 ws[kT][kTS];                    // w[k][col]
};

using ft5::mma::ldsm_x4;
using ft5::mma::ldsm_x4_t;
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  ft5::mma::mma_bf16_16816(c, a, b);
}

// The A fragment (16 x 16) at (m0, k0) of a tile stored [m][k].
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16 (*t)[kTS],
                                       int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, &t[m0 + (l & 7) + 8 * ((l >> 3) & 1)][k0 + 8 * (l >> 4)]);
}

// The A fragment (16 x 16) at (m0, k0) of a tile stored [k][m].
__device__ __forceinline__ void frag_a_t(uint32_t a[4], const bf16 (*t)[kTS],
                                         int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, &t[k0 + (l & 7) + 8 * (l >> 4)][m0 + 8 * ((l >> 3) & 1)]);
}

// The B fragments (16 x 8) at k0 of the two column tiles n0 and n0 + 8
// (b[0..1] and b[2..3]) of a tile stored [k][n].
__device__ __forceinline__ void frag_b2_kn(uint32_t b[4], const bf16 (*t)[kTS],
                                           int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, &t[k0 + (l & 7) + 8 * ((l >> 3) & 1)][n0 + 8 * (l >> 4)]);
}

// The same from a tile stored [n][k].
__device__ __forceinline__ void frag_b2_nk(uint32_t b[4], const bf16 (*t)[kTS],
                                           int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, &t[n0 + (l & 7) + 8 * (l >> 4)][k0 + 8 * ((l >> 3) & 1)]);
}

// 8 consecutive values as bf16, `valid` of them in range (the rest 0);
// one 16-byte load (two for f32) where all are in range and `vec` says the
// rows are 16-byte aligned
__device__ __forceinline__ uint4 load8(const bf16* p, int valid, bool vec) {
  if (vec && valid >= 8) return *reinterpret_cast<const uint4*>(p);
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  bf16* o = reinterpret_cast<bf16*>(&out);
  for (int i = 0; i < 8 && i < valid; ++i) o[i] = p[i];
  return out;
}
__device__ __forceinline__ uint4 load8(const float* p, int valid, bool vec) {
  float v[8];
  if (vec && valid >= 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0.f;
  }
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

// Stage the 64 x 64 tile src[r][c] (row stride `stride`; rows >= n_rows
// and columns >= n_cols read 0) into dst, NT threads, 8 columns each.
template <int NT, typename TS>
__device__ __forceinline__ void stage(bf16 (*dst)[kTS], const TS* src,
                                      size_t stride, int n_rows, int n_cols,
                                      bool vec) {
#pragma unroll
  for (int idx = threadIdx.x; idx < kT * kT / 8; idx += NT) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    const int valid = r < n_rows ? n_cols - c : 0;
    *reinterpret_cast<uint4*>(&dst[r][c]) =
        valid > 0 ? load8(src + r * stride + c, valid, vec)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The f32 logits of a 16 x (8 WN) warp tile at (wrow, wcol) of the 64 x 64
// tile of rows r0.., columns c0..; NT threads stage the operands. In the
// accumulator layout of m16n8: acc[j][2h + e] is row wrow + g + 8h, column
// wcol + 8j + 2tq + e (g = lane / 4, tq = lane % 4).
// kExact: d is a multiple of 64 and x's rows are 16-byte aligned.
template <int NT, int WN, bool kExact, typename TW>
__device__ __forceinline__ void mma_logits(float acc[WN][4],
                                           const bf16* __restrict__ x,
                                           const TW* __restrict__ w, int r0,
                                           int c0, int rows, int d, int V,
                                           bool x_vec, bool w_vec,
                                           MmaTiles& s, int wrow, int wcol) {
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kT) {
    __syncthreads();                   // the tiles' last readers are done
    stage<NT>(s.xs, x + static_cast<size_t>(r0) * d + k0, d, rows - r0,
              kExact ? kT : d - k0, kExact || x_vec);
    stage<NT>(s.ws, w + static_cast<size_t>(k0) * V + c0, V,
              kExact ? kT : d - k0, V - c0, w_vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      uint32_t a[4];
      frag_a(a, s.xs, wrow, kk);
#pragma unroll
      for (int j = 0; j < WN; j += 2) {
        uint32_t b[4];
        frag_b2_kn(b, s.ws, wcol + j * 8, kk);
        mma_bf16(acc[j], a, b);
        mma_bf16(acc[j + 1], a, b + 2);
      }
    }
  }
}

// sum / max over the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// dlogits of the thread's warp-tile values, rounded to bf16 and stored in
// dl[row][col] of the 64 x 64 tile
__device__ __forceinline__ void store_dlogits(bf16 (*dl)[kTS],
                                              float lg[4][4],
                                              const Grad& g,
                                              const RowGrad q[2], int c0,
                                              int V, int wrow, int wcol) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = wcol + j * 8 + tq * 2;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[e] = c0 + c + e < V
            ? dlogit(g, q[h], lg[j][2 * h + e] * g.logit_scale, c0 + c + e)
            : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(&dl[wrow + gq + 8 * h][c]) =
          __floats2bfloat162_rn(v[0], v[1]);
    }
}

constexpr int kFwdMmaThreads = 128;  // 4 warps, each 16 rows x 64 columns

template <typename TW, bool kExact>
__global__ void __launch_bounds__(kFwdMmaThreads)
flce_fwd_mma_kernel(const bf16* __restrict__ x, const TW* __restrict__ w,
                    float* __restrict__ part_m, float* __restrict__ part_se,
                    float* __restrict__ part_sl, int rows, int d, int V,
                    int splits, float logit_scale, int smooth, bool x_vec,
                    bool w_vec) {
  __shared__ __align__(16) MmaTiles s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * kBR, split = blockIdx.y;
  int t_begin, t_end;
  split_range(V, splits, split, &t_begin, &t_end);

  float m[2], se[2], sl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = ft5::kNegInf, se[h] = sl[h] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * kBV;
    float acc[8][4];
    mma_logits<kFwdMmaThreads, 8, kExact>(acc, x, w, r0, c0, rows, d, V,
                                          x_vec, w_vec, s, warp * 16, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = ft5::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[j][2 * h + e] *= logit_scale;
          if (c0 + j * 8 + tq * 2 + e < V)
            tmax = fmaxf(tmax, acc[j][2 * h + e]);
        }
      const float m_new = fmaxf(fmaxf(m[h], quad_max(tmax)), ft5::kNegInf);
      float p = 0.f, lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + j * 8 + tq * 2 + e < V) {
            p += expf(acc[j][2 * h + e] - m_new);
            lsum += acc[j][2 * h + e];
          }
      se[h] = se[h] * expf(m[h] - m_new) + quad_sum(p);
      m[h] = m_new;
      if (smooth) sl[h] += quad_sum(lsum);
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + warp * 16 + g + 8 * h;
      if (r < rows) {
        const size_t o = static_cast<size_t>(split) * rows + r;
        part_m[o] = m[h];
        part_se[o] = se[h];
        part_sl[o] = sl[h];
      }
    }
  }
}

// dx partial sums of one vocab split and one chunk of d (NCH blocks of 64
// columns from d0 = blockIdx.z * NCH * 64): warp (wr, wc) = (warp / 2,
// warp % 2) keeps rows 16 wr.., columns d0 + 64 ch + 32 wc.. of each
// block. kExact: d = NCH * 64, one chunk, x's rows 16-byte aligned.
template <typename TW, int NCH, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flce_dx_mma_kernel(const bf16* __restrict__ x, const TW* __restrict__ w,
                   Grad g, float* __restrict__ dx_part, int rows, int d_arg,
                   int V, int splits, bool x_vec, bool w_vec) {
  const int d = kExact ? NCH * kT : d_arg;
  const int d0 = kExact ? 0 : blockIdx.z * NCH * kT;
  __shared__ __align__(16) MmaTiles s;
  __shared__ __align__(16) bf16 dls[kT][kTS];   // dl[row][col]
  __shared__ __align__(16) bf16 wd[kT][kTS];    // w[d col][col]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = (warp >> 1) * 16, wcol = (warp & 1) * 32;
  const int r0 = blockIdx.x * kBR, split = blockIdx.y;
  int t_begin, t_end;
  split_range(V, splits, split, &t_begin, &t_end);

  RowGrad q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) q[h] = row_grad(g, r0 + wrow + gq + 8 * h, rows);
  float acc[NCH][4][4];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ch][j][e] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * kBV;
    float lg[4][4];
    mma_logits<kThreads, 4, kExact>(lg, x, w, r0, c0, rows, d, V, x_vec,
                                    w_vec, s, wrow, wcol);
    store_dlogits(dls, lg, g, q, c0, V, wrow, wcol);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      __syncthreads();           // dls written; the last wd chunk read
      const int k0 = d0 + ch * kT;
      stage<kThreads>(wd, w + static_cast<size_t>(k0) * V + c0, V,
                      kExact ? kT : d - k0, V - c0, w_vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        uint32_t a[4];
        frag_a(a, dls, wrow, kk);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b[4];
          frag_b2_nk(b, wd, wcol + j * 8, kk);
          mma_bf16(acc[ch][j], a, b);
          mma_bf16(acc[ch][j + 1], a, b + 2);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + wrow + gq + 8 * h;
    if (r >= rows) continue;
    float* out = dx_part + (static_cast<size_t>(split) * rows + r) * d;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = d0 + ch * kT + wcol + j * 8 + tq * 2;
        if (kExact || (col + 1 < d && d % 2 == 0))
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[ch][j][2 * h], acc[ch][j][2 * h + 1]);
        else if (col < d) {
          out[col] = acc[ch][j][2 * h];
          if (col + 1 < d) out[col + 1] = acc[ch][j][2 * h + 1];
        }
      }
  }
}

// dW of one vocab tile and one chunk of d (NCH blocks of 64 rows of dW
// from d0 = blockIdx.y * NCH * 64) over all row blocks: warp (wr, wc)
// keeps d rows d0 + 64 ch + 16 wr.., columns 32 wc..
template <typename TW, int NCH, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flce_dw_mma_kernel(const bf16* __restrict__ x, const TW* __restrict__ w,
                   Grad g, TW* __restrict__ dw, int rows, int d_arg, int V,
                   bool x_vec, bool w_vec) {
  const int d = kExact ? NCH * kT : d_arg;
  const int d0 = kExact ? 0 : blockIdx.y * NCH * kT;
  __shared__ __align__(16) MmaTiles s;
  __shared__ __align__(16) bf16 dls[kT][kTS];   // dl[row][col]
  __shared__ __align__(16) bf16 xd[kT][kTS];    // x[row][d col]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wrow = (warp >> 1) * 16, wcol = (warp & 1) * 32;
  const int c0 = blockIdx.x * kBV;

  float acc[NCH][4][4];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ch][j][e] = 0.f;

  for (int r0 = 0; r0 < rows; r0 += kBR) {
    RowGrad q[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      q[h] = row_grad(g, r0 + wrow + gq + 8 * h, rows);
    float lg[4][4];
    mma_logits<kThreads, 4, kExact>(lg, x, w, r0, c0, rows, d, V, x_vec,
                                    w_vec, s, wrow, wcol);
    store_dlogits(dls, lg, g, q, c0, V, wrow, wcol);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      __syncthreads();           // dls written; the last xd chunk read
      const int k0 = d0 + ch * kT;
      stage<kThreads>(xd, x + static_cast<size_t>(r0) * d + k0, d,
                      rows - r0, kExact ? kT : d - k0, kExact || x_vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kT; kk += 16) {
        uint32_t a[4];
        frag_a_t(a, xd, wrow, kk);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b[4];
          frag_b2_kn(b, dls, wcol + j * 8, kk);
          mma_bf16(acc[ch][j], a, b);
          mma_bf16(acc[ch][j + 1], a, b + 2);
        }
      }
    }
  }
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kd = d0 + ch * kT + wrow + gq + 8 * h;
      if (!kExact && kd >= d) continue;
      TW* out = dw + static_cast<size_t>(kd) * V;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + wcol + j * 8 + tq * 2 + e;
          if (col < V) out[col] = ft5::from_float<TW>(acc[ch][j][2 * h + e]);
        }
    }
}

// The backward's chunks of d: ceil(d / 512) of them, each NCH blocks of
// 64 columns (the last chunk masked where d ends inside it)
struct Chunks {
  int n, nch;
};
Chunks chunks_of(int d) {
  const int n = (d + 8 * kT - 1) / (8 * kT);
  const int per = (d + n - 1) / n;
  return {n, (per + kT - 1) / kT};
}

// ~kTargetCtas CTAs (each row block taking `per_rb` of them for every
// split), and no split left without a vocab tile
int n_splits(int rows, int V, int per_rb) {
  const int n_rb = (rows + kBR - 1) / kBR, n_vt = (V + kBV - 1) / kBV;
  if (n_rb == 0) return 1;
  const int cta_rb = n_rb * per_rb;
  const int want =
      std::max(1, std::min(n_vt, (kTargetCtas + cta_rb - 1) / cta_rb));
  const int per = (n_vt + want - 1) / want;
  return (n_vt + per - 1) / per;
}

template <typename T>
cudaError_t merge_dx(const float* dx_part, void* dx, int rows, int d,
                     int splits, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(rows) * d;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  flce_dx_merge_kernel<T><<<blocks, 256, 0, stream>>>(
      dx_part, static_cast<T*>(dx), n, splits);
  return cudaGetLastError();
}

// the CUDA-core form, f32 activations and weight; NC = 32-column blocks of
// a chunk of d; kExact: d = NC * 32
template <int NC, bool kExact>
cudaError_t launch_bwd_f32(const float* x, const float* w, const Grad& g,
                           float* dx_part, void* dx, void* dw, int rows,
                           int d, int V, int splits, int n_chunks,
                           cudaStream_t stream) {
  const int n_rb = (rows + kBR - 1) / kBR, n_vt = (V + kBV - 1) / kBV;
  if (n_rb > 0) {
    flce_dx_kernel<NC, kExact><<<dim3(n_rb, splits, n_chunks), kThreads, 0,
                                 stream>>>(x, w, g, dx_part, rows, d, V,
                                           splits);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess)
      err = merge_dx<float>(dx_part, dx, rows, d, splits, stream);
    if (err != cudaSuccess) return err;
  }
  flce_dw_kernel<NC, kExact><<<dim3(n_vt, n_chunks), kThreads, 0, stream>>>(
      x, w, g, static_cast<float*>(dw), rows, d, V);
  return cudaGetLastError();
}

// whether every row of a (n_rows, n) row-major array starts 16-byte
// aligned
template <typename T>
bool rows_aligned(const T* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (static_cast<size_t>(n) * sizeof(T)) % 16 == 0;
}

// the tensor-core form, bf16 activations; NCH = 64-column blocks of a
// chunk of d; kExact: d = NCH * 64 and x's rows 16-byte aligned
template <typename TW, int NCH, bool kExact>
cudaError_t launch_bwd_mma(const bf16* x, const TW* w, const Grad& g,
                           float* dx_part, void* dx, void* dw, int rows,
                           int d, int V, int splits, int n_chunks,
                           cudaStream_t stream) {
  const int n_rb = (rows + kBR - 1) / kBR, n_vt = (V + kBV - 1) / kBV;
  const bool x_vec = rows_aligned(x, d), w_vec = rows_aligned(w, V);
  if (n_rb > 0) {
    flce_dx_mma_kernel<TW, NCH, kExact>
        <<<dim3(n_rb, splits, n_chunks), kThreads, 0, stream>>>(
            x, w, g, dx_part, rows, d, V, splits, x_vec, w_vec);
    cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess)
      err = merge_dx<bf16>(dx_part, dx, rows, d, splits, stream);
    if (err != cudaSuccess) return err;
  }
  flce_dw_mma_kernel<TW, NCH, kExact>
      <<<dim3(n_vt, n_chunks), kThreads, 0, stream>>>(
      x, w, g, static_cast<TW*>(dw), rows, d, V, x_vec, w_vec);
  return cudaGetLastError();
}

cudaError_t dispatch_bwd_f32(int d, const void* x, const void* w,
                             const Grad& g, float* dx_part, void* dx,
                             void* dw, int rows, int V, int splits,
                             cudaStream_t s) {
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const Chunks c = chunks_of(d);
  const bool exact = c.n == 1 && d == c.nch * kT;
  switch (c.nch) {
#define FT5_FLCE_CASE(N)                                                   \
  case N:                                                                  \
    return exact ? launch_bwd_f32<2 * N, true>(xp, wp, g, dx_part, dx, dw, \
                                               rows, d, V, splits, c.n, s) \
                 : launch_bwd_f32<2 * N, false>(xp, wp, g, dx_part, dx,    \
                                                dw, rows, d, V, splits,    \
                                                c.n, s);
    FT5_FLCE_CASE(1) FT5_FLCE_CASE(2) FT5_FLCE_CASE(3) FT5_FLCE_CASE(4)
    FT5_FLCE_CASE(5) FT5_FLCE_CASE(6) FT5_FLCE_CASE(7) FT5_FLCE_CASE(8)
#undef FT5_FLCE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TW>
cudaError_t dispatch_bwd_mma(int d, const void* x, const void* w,
                             const Grad& g, float* dx_part, void* dx,
                             void* dw, int rows, int V, int splits,
                             cudaStream_t s) {
  const bf16* xp = static_cast<const bf16*>(x);
  const TW* wp = static_cast<const TW*>(w);
  const Chunks c = chunks_of(d);
  const bool exact =
      c.n == 1 && d == c.nch * kT && rows_aligned(xp, d);
  switch (c.nch) {
#define FT5_FLCE_CASE(N)                                                   \
  case N:                                                                  \
    return exact ? launch_bwd_mma<TW, N, true>(xp, wp, g, dx_part, dx, dw, \
                                               rows, d, V, splits, c.n, s) \
                 : launch_bwd_mma<TW, N, false>(xp, wp, g, dx_part, dx,    \
                                                dw, rows, d, V, splits,    \
                                                c.n, s);
    FT5_FLCE_CASE(1) FT5_FLCE_CASE(2) FT5_FLCE_CASE(3) FT5_FLCE_CASE(4)
    FT5_FLCE_CASE(5) FT5_FLCE_CASE(6) FT5_FLCE_CASE(7) FT5_FLCE_CASE(8)
#undef FT5_FLCE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fwd_f32(const float* x, const float* w, float* pm,
                           float* pse, float* psl, int rows, int d, int V,
                           int splits, float scale, int smooth,
                           cudaStream_t stream) {
  const int n_rb = (rows + kBR - 1) / kBR;
  if (n_rb == 0) return cudaSuccess;
  if (d % kBK == 0)
    flce_fwd_kernel<true><<<dim3(n_rb, splits), kThreads, 0, stream>>>(
        x, w, pm, pse, psl, rows, d, V, splits, scale, smooth);
  else
    flce_fwd_kernel<false><<<dim3(n_rb, splits), kThreads, 0, stream>>>(
        x, w, pm, pse, psl, rows, d, V, splits, scale, smooth);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_fwd_mma(const bf16* x, const TW* w, float* pm, float* pse,
                           float* psl, int rows, int d, int V, int splits,
                           float scale, int smooth, cudaStream_t stream) {
  const int n_rb = (rows + kBR - 1) / kBR;
  if (n_rb == 0) return cudaSuccess;
  const bool x_vec = rows_aligned(x, d), w_vec = rows_aligned(w, V);
  if (d % kT == 0 && x_vec)
    flce_fwd_mma_kernel<TW, true>
        <<<dim3(n_rb, splits), kFwdMmaThreads, 0, stream>>>(
            x, w, pm, pse, psl, rows, d, V, splits, scale, smooth, x_vec,
            w_vec);
  else
    flce_fwd_mma_kernel<TW, false>
        <<<dim3(n_rb, splits), kFwdMmaThreads, 0, stream>>>(
            x, w, pm, pse, psl, rows, d, V, splits, scale, smooth, x_vec,
            w_vec);
  return cudaGetLastError();
}

}  // namespace

// The vocab splits of the forward (backward = 0) or of the dx kernel
// (backward = 1, whose CTAs also split d into chunks) for `rows` x `V`.
FT5_EXPORT int ft5_flce_splits(int rows, int d, int V, int backward) {
  return n_splits(rows, V, backward ? chunks_of(d).n : 1);
}

// Partial (max, sum of exp, sum of logits) of each row over each split:
// x (rows, d) f32 or bf16 (`x_dtype`); w (d, V) in x's dtype, or f32 when
// `w_f32`; part_* (splits, rows) f32.
FT5_EXPORT int ft5_flce_fwd(const void* x, const void* w, float* part_m,
                            float* part_se, float* part_sl, int rows, int d,
                            int V, int splits, int x_dtype, int w_f32,
                            float logit_scale, int smooth, void* stream) {
  if (d <= 0 || V <= 0 || splits <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ft5::kFloat32 && !w_f32)
    return launch_fwd_f32(static_cast<const float*>(x),
                          static_cast<const float*>(w), part_m, part_se,
                          part_sl, rows, d, V, splits, logit_scale, smooth,
                          s);
  const bf16* xb = static_cast<const bf16*>(x);
  if (x_dtype == ft5::kBFloat16)
    return w_f32 ? launch_fwd_mma(xb, static_cast<const float*>(w), part_m,
                                  part_se, part_sl, rows, d, V, splits,
                                  logit_scale, smooth, s)
                 : launch_fwd_mma(xb, static_cast<const bf16*>(w), part_m,
                                  part_se, part_sl, rows, d, V, splits,
                                  logit_scale, smooth, s);
  return cudaErrorInvalidValue;
}

// lse and the row sum of the logits from the first `n_merge` of the
// `stride` splits in part_*.
FT5_EXPORT int ft5_flce_merge(const float* part_m, const float* part_se,
                              const float* part_sl, float* lse, float* total,
                              int rows, int stride, int n_merge,
                              void* stream) {
  if (n_merge < 0 || n_merge > stride) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  flce_merge_kernel<<<(rows + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      part_m, part_se, part_sl, lse, total, rows, n_merge);
  return cudaGetLastError();
}

// dx (rows, d) in x's dtype and dw (d, V) in w's dtype; dx_part is
// (splits, rows, d) f32 scratch; labels int32, lse, dloss, dz (rows,) f32.
FT5_EXPORT int ft5_flce_bwd(const void* x, const void* w, const int* labels,
                            const float* lse, const float* dloss,
                            const float* dz, float* dx_part, void* dx,
                            void* dw, int rows, int d, int V, int splits,
                            int total_classes, int ignore_index, int smooth,
                            int x_dtype, int w_f32, float logit_scale,
                            float lse_square_scale, float smoothing,
                            void* stream) {
  if (d <= 0 || V <= 0 || splits <= 0) return cudaErrorInvalidValue;
  const Grad g{labels, lse, dloss, dz, total_classes, ignore_index, smooth,
               logit_scale, lse_square_scale, smoothing};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ft5::kFloat32 && !w_f32)
    return dispatch_bwd_f32(d, x, w, g, dx_part, dx, dw, rows, V, splits, s);
  if (x_dtype == ft5::kBFloat16)
    return w_f32 ? dispatch_bwd_mma<float>(d, x, w, g, dx_part, dx, dw, rows,
                                           V, splits, s)
                 : dispatch_bwd_mma<bf16>(d, x, w, g, dx_part, dx, dw, rows,
                                          V, splits, s);
  return cudaErrorInvalidValue;
}
