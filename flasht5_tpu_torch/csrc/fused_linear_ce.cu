// Fused lm_head matmul + cross-entropy, forward and backward.
//
// Replaces the Pallas kernels of flasht5_tpu/ops/fused_linear_ce.py:
// _fwd_kernel (launched at :253) and _bwd_kernel (:320). As there, the
// logits are computed from x (rows, d) and w (d, V) in f32 (w rounded to
// x's dtype), scaled by logit_scale, and never reach device memory as a
// (rows, V) array.
//
// Bound on the H100: operations. At the train step's shape (2048 rows,
// d 512, V 32768) the forward is 68.7 GFLOP (0.0695 ms at the bf16
// tensor-core rate) and the backward three such products (0.208 ms); the
// bytes are x, w and the (rows,) vectors. bf16 activations (the train step
// and scoring paths) run on the tensor cores, f32 activations on the CUDA
// cores (f32 FMAs on 4 x 4 or 4 x 2 register tiles, 256 threads a CTA:
// the port uses no TF32). Every form sums exact products in f32 and
// differs from the plain version only in the order of the sums.
//
// The TPU grid runs its (vocab tile, row block) steps in order and carries
// sums in scratch memory between them. Here CTAs run in parallel, and no
// atomics are used: every run gives the same bits.
//
// - bf16 forward (tma::launch_fwd_wgmma, for d a multiple of 8 and x
//   16-byte aligned: every path's shapes): a CTA per (row block of 128,
//   vocab split) runs a TMA ring and wgmma.m64n128k16 in two consumer
//   warpgroups and reduces each tile's logits on the accumulators. The
//   f32 lm_head is read from device memory about once a call: for more
//   than 512 rows (the train step) w is rounded to bf16 and transposed once,
//   by vocabulary slabs into a scratch of at most 60 MiB
//   (flce_cast_t_kernel), x staying in shared memory where d <= 512; for
//   fewer (scoring) each CTA rounds the raw f32 tiles in shared memory as
//   they land, the row blocks of a tile reading it from the L2 (see the
//   section below). Each CTA writes per-row partial (max, sum of exp, sum
//   of logits); flce_merge_kernel folds the splits into lse, a warp a row.
//   The wrapper's fwd_plan sizes the splits for about one CTA an SM: at
//   the scoring batches' 256 label rows there are only 2 row blocks.
// - the other bf16 forward (flce_fwd_mma_kernel: d not a multiple of 8, x
//   not 16-byte aligned) and the f32 one (flce_fwd_kernel): a CTA per (row
//   block of 64, vocab split), operands staged one K-step at a time (no
//   ring), any d; ft5_flce_splits gives ~4 CTAs an SM.
// - bf16 backward (launch_bwd_gemm): the TPU kernel computes each logits
//   tile once and contracts it both ways in the same body (:127-187). Here
//   the rows go in chunks and the vocabulary in slabs, sized by the
//   wrapper's bwd_plan so that the workspace stays within 64 MB whatever
//   the rows, d and V. For each (chunk, slab): the slab of an f32 lm_head
//   is rounded to bf16 once (the TPU kernel rounds each tile as it loads:
//   the same values); one GEMM forms the slab's logits and, in its
//   epilogue, the bf16 dlogits (probabilities, one-hot label, smoothing,
//   z-loss, rounded to x's dtype as the TPU kernel does at :159) into the
//   workspace, staged through shared memory for 16-byte stores; two more
//   GEMMs contract them: dW[:, slab] = x^T dl over the chunk's rows
//   (written once; chunks after the first add to it in order) and dx +=
//   dl w^T (K split for parallelism; the f32 partials are added in order
//   by flce_dx_reduce_kernel, which also carries dx's f32 sums from slab
//   to slab). Each logits tile is computed once, at every d. The GEMMs are
//   mma.sync with a 3-stage cp.async ring (flce_gemm_kernel, below); at
//   the train step's shape they reach ~170 TFLOP/s each, the logits GEMM
//   less (its epilogue evaluates an exp per logit). wgmma with a TMA
//   producer is the next step.
// - f32 backward: the dx kernel, a CTA per (row block, vocab split, chunk
//   of d), loops over the split's vocab tiles and keeps its (64 x chunk)
//   dx sums in registers; flce_dx_reduce_kernel adds the splits in order.
//   The dW kernel, a CTA per (vocab tile, chunk of d), loops over all row
//   blocks and keeps its (chunk x 64) dW sums in registers. Both recompute
//   their logits tiles over the whole d and form dlogits in registers. The
//   register sums hold at most 512 columns of d, so a wider d is cut into
//   ceil(d / 512) equal chunks (multiples of 64, the last one masked), one
//   CTA each, each recomputing the logits over the whole d.
//
// Rows, vocab columns and d need not be multiples of the tiles: rows past
// the end read 0 and count as ignored, columns past V and d past its end
// are masked (an operand whose rows are not 16-byte aligned, such as x at a
// d that is not a multiple of 8, is loaded element by element instead of
// by 16-byte copies).

#include <algorithm>
#include <type_traits>

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
// splits: a warp per row, lane l taking splits l, l + 32, ..., then the
// lanes' maxima and sums folded by a fixed butterfly (the same order on
// every run)
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void flce_merge_kernel(const float* __restrict__ part_m,
                                  const float* __restrict__ part_se,
                                  const float* __restrict__ part_sl,
                                  float* __restrict__ lse,
                                  float* __restrict__ total, int rows,
                                  int n_merge) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  float m = ft5::kNegInf;
  for (int sp = lane; sp < n_merge; sp += 32)
    m = fmaxf(m, part_m[static_cast<size_t>(sp) * rows + r]);
  m = warp_max(m);
  float se = 0.f, sl = 0.f;
  for (int sp = lane; sp < n_merge; sp += 32) {
    const size_t o = static_cast<size_t>(sp) * rows + r;
    se += part_se[o] * expf(part_m[o] - m);
    sl += part_sl[o];
  }
  se = warp_sum(se);
  sl = warp_sum(sl);
  if (lane == 0) {
    lse[r] = logf(se) + m;
    total[r] = sl;
  }
}

// ---------------------------------------------------------------------------
// backward: dlogits (both forms) and the f32 form's dx and dW kernels
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

// dx from the splits' f32 partials (splits x n), added in split order to
// the f32 sums carried in dx_acc (none when `first`); `last` writes x's
// dtype into dx, else the sums back into dx_acc. The f32 form has one
// pass (first and last); the bf16 form carries dx_acc from vocabulary slab
// to slab.
template <typename T>
__global__ void flce_dx_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ dx_acc,
                                      T* __restrict__ dx, size_t n,
                                      int splits, int first, int last) {
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = first ? 0.f : dx_acc[e];
    for (int sp = 0; sp < splits; ++sp) v += part[sp * n + e];
    if (last)
      dx[e] = ft5::from_float<T>(v);
    else
      dx_acc[e] = v;
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
// the bf16 forward on the tensor cores (mma.sync m16n8k16, f32 sums)
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

// The B fragments (16 x 8) at k0 of the two column tiles n0 and n0 + 8
// (b[0..1] and b[2..3]) of a tile stored [k][n].
__device__ __forceinline__ void frag_b2_kn(uint32_t b[4], const bf16 (*t)[kTS],
                                           int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, &t[k0 + (l & 7) + 8 * ((l >> 3) & 1)][n0 + 8 * (l >> 4)]);
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

// ---------------------------------------------------------------------------
// the bf16 forward on TMA + wgmma (shapes TMA can describe)
// ---------------------------------------------------------------------------
//
// wgmma reads its B operand K-major, in the 128-byte swizzled layout of
// a TMA tile (as qmm_wgmma_kernel's), and w (d x V) is V-major. So w is
// rounded to bf16 and transposed, slab by slab of the vocabulary, into a
// (slab x d) scratch (flce_cast_t_kernel: the f32 lm_head read from device
// memory once a call, 96 MB moved at the train step), or, with few rows
// (kConvert), its raw f32 tiles (64 k x 128 columns) stream through the
// ring and the consumers round and transpose each into a bf16 tile in
// shared memory (convert_f32) before its products: no scratch and no cast
// pass, each row block reading the f32 tiles (2 at scoring's 256 rows).
// flce_fwd_wgmma_kernel: a CTA per (row block of 128, vocab split);
// warpgroup 0's first thread is the producer, keeping a ring of TMA loads
// in flight, each stage completing on its `full` mbarrier and freed by the
// consumers' arrivals on its `empty` one; warpgroups 1 and 2 each own 64
// rows and run wgmma.m64n128k16 over the ring, one group kept in flight,
// then reduce each 128-column tile's logits on the accumulator layout
// (online max, sum of exp, sum of logits, in the TPU kernel's order) before
// the next. Where d <= 512 (kResident) the CTA's 128 rows of x (at most
// 128 KB) are loaded once and stay in shared memory while only w streams;
// otherwise x streams beside w.

namespace tma {

using ft5::mma::bf16;
constexpr int kBM = 128;            // rows of a CTA: two warpgroups of 64
constexpr int kBN = 128;            // vocab columns of a tile
constexpr int kBK = 64;             // d of a K step: one swizzled row
constexpr int kTile = kBM * kBK * 2;  // 16 KB: an x or a w^T tile
constexpr int kResidentSteps = 8;   // d <= 512: x stays resident
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;

// The three forms: x resident (d <= 512) or streamed beside w, both on a
// bf16 w^T from the scratch; or, for few rows, the raw f32 w streamed and
// converted in shared memory (no scratch, no cast pass).
enum Form { kResident = 0, kStream = 1, kConvert = 2 };

template <int kForm>
struct Ring {
  static constexpr int kStages =
      kForm == kResident ? 5 : kForm == kStream ? 6 : 3;
  // a stage: the w^T tile (kResident), or it and then x's (kStream), or
  // the raw f32 w tile (64 k x 128 columns) and then x's (kConvert)
  static constexpr int kStageBytes =
      kForm == kResident ? kTile : kForm == kStream ? 2 * kTile : 3 * kTile;
  static constexpr int kXOffset = kForm == kConvert ? 2 * kTile : kTile;
  static constexpr int kXBytes = kForm == kResident ? kResidentSteps * kTile
                                                    : 0;
  static constexpr int kConv = kForm == kConvert ? 3 : 0;  // bf16 w^T tiles
  static constexpr int kSmem = kXBytes + kStages * kStageBytes +
                               kConv * kTile + (2 * kStages + 1) * 8 + 1024;
};

// The raw f32 tile (64 k rows x 128 columns, 512-byte rows) into the bf16
// w^T tile (128 columns x 64 k) in the 128-byte swizzled K-major layout, by
// the 256 consumer threads: thread c takes column c % 128 and the 16-byte
// chunks of 8 k c / 128, + 2, + 4, + 6 (a warp reads 32 consecutive words
// of a row; each 8 threads of a store phase write 8 distinct chunks).
__device__ __forceinline__ void convert_f32(const uint8_t* raw, uint8_t* dst,
                                            int c) {
  const float* src = reinterpret_cast<const float*>(raw);
  const int col = c & 127;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = (c >> 7) + 2 * i;
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = ft5::mma::pack_bf16(src[(8 * kc + 2 * j) * kBN + col],
                                 src[(8 * kc + 2 * j + 1) * kBN + col]);
    *reinterpret_cast<uint4*>(dst + col * 128 + ((kc ^ (col & 7)) << 4)) =
        out;
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 1)
flce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw,
                      float* __restrict__ part_m, float* __restrict__ part_se,
                      float* __restrict__ part_sl, int rows, int d, int n,
                      int per, int split0, float logit_scale, int smooth) {
  using R = Ring<kForm>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = base;                         // resident x tiles
  uint8_t* ring = base + R::kXBytes;
  uint8_t* conv = ring + R::kStages * R::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + R::kConv * kTile);
  uint64_t* empty = full + R::kStages;
  uint64_t* xbar = empty + R::kStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int r0 = blockIdx.x * kBM, split = blockIdx.y;
  const int n_vt = (n + kBN - 1) / kBN;
  const int t_begin = min(n_vt, split * per), t_end = min(n_vt, t_begin + per);
  const int nk = (d + kBK - 1) / kBK;

  if (tid == 0) {
    for (int st = 0; st < R::kStages; ++st) {
      ft5::mma::mbar_init(&full[st], 1);
      ft5::mma::mbar_init(&empty[st], kConsumerWarps);
    }
    ft5::mma::mbar_init(xbar, 1);
    ft5::mma::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {          // the producer
    if (tid == 0) {
      if (kForm == kResident) {
        ft5::mma::mbar_expect_tx(xbar, nk * kTile);
        for (int k = 0; k < nk; ++k)
          ft5::mma::tma_load_2d(xs + k * kTile, &tmx, xbar, k * kBK, r0);
      }
      const int steps = (t_end - t_begin) * nk;
      for (int i = 0; i < steps; ++i) {
        const int st = i % R::kStages;
        if (i >= R::kStages)
          ft5::mma::mbar_wait(&empty[st], (i / R::kStages - 1) & 1);
        const int t = t_begin + i / nk, k = i % nk;
        uint8_t* stage = ring + st * R::kStageBytes;
        ft5::mma::mbar_expect_tx(&full[st], R::kStageBytes);
        if (kForm != kResident)
          ft5::mma::tma_load_2d(stage + R::kXOffset, &tmx, &full[st],
                                k * kBK, r0);
        if (kForm == kConvert)   // the raw tile: {column, k row}
          ft5::mma::tma_load_2d(stage, &tmw, &full[st], t * kBN, k * kBK);
        else                     // the w^T tile: {k, vocab row}
          ft5::mma::tma_load_2d(stage, &tmw, &full[st], k * kBK, t * kBN);
      }
    }
    return;
  }

  const int cw = wg - 1;                       // rows 64 cw .. of the CTA
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  float m[2], se[2], sl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = ft5::kNegInf, se[h] = sl[h] = 0.f;
  if (kForm == kResident) ft5::mma::mbar_wait(xbar, 0);

  float acc[64];
  int i = 0, pending = -1;     // the stage whose products may still run
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) ft5::mma::mbar_arrive(&empty[st]);
  };
  for (int t = t_begin; t < t_end; ++t) {
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    for (int k = 0; k < nk; ++k, ++i) {
      const int st = i % R::kStages;
      ft5::mma::mbar_wait(&full[st], (i / R::kStages) & 1);
      const uint8_t* stage = ring + st * R::kStageBytes;
      const uint8_t* xt =
          kForm == kResident ? xs + k * kTile : stage + R::kXOffset;
      const uint8_t* wt = stage;
      if (kForm == kConvert) {
        // tile i % 3 was last read by step i - 3's products, done in both
        // warpgroups: each waited for them before step i - 1's barrier
        uint8_t* ct = conv + (i % R::kConv) * kTile;
        convert_f32(stage, ct, tid - 128);
        ft5::mma::fence_proxy_async();
        ft5::mma::named_sync(1, 256);
        wt = ct;
      }
      const uint64_t da = ft5::mma::wgmma_desc_sw128(xt + cw * (kTile / 2));
      const uint64_t db = ft5::mma::wgmma_desc_sw128(wt);
      ft5::mma::fence_all(acc);
      ft5::mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        ft5::mma::wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
      ft5::mma::wgmma_commit();
      ft5::mma::wgmma_wait<1>();     // the previous step's products are done
      if (pending >= 0) release(pending);
      pending = st;
    }
    ft5::mma::wgmma_wait<0>();
    ft5::mma::fence_all(acc);
    release(pending);
    pending = -1;

    // the tile's logits (row 16 warp + g + 8h of the warpgroup's 64, column
    // c0 + 8j + 2tq + e at acc[4j + 2h + e]) into the row's running sums
    const int c0 = t * kBN;
    const bool whole = c0 + kBN <= n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = ft5::kNegInf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[4 * j + 2 * h + e];
          v *= logit_scale;
          if (whole || c0 + 8 * j + 2 * tq + e < n) tmax = fmaxf(tmax, v);
        }
      const float m_new = fmaxf(fmaxf(m[h], quad_max(tmax)), ft5::kNegInf);
      float p = 0.f, lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (whole || c0 + 8 * j + 2 * tq + e < n) {
            const float v = acc[4 * j + 2 * h + e];
            p += expf(v - m_new);
            lsum += v;
          }
      se[h] = se[h] * expf(m[h] - m_new) + quad_sum(p);
      m[h] = m_new;
      if (smooth) sl[h] += quad_sum(lsum);
    }
  }
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 64 * cw + 16 * warp + g + 8 * h;
      if (r < rows) {
        const size_t o = static_cast<size_t>(split0 + split) * rows + r;
        part_m[o] = m[h];
        part_se[o] = se[h];
        part_sl[o] = sl[h];
      }
    }
  }
}

// w's columns [v0, v0 + n) (d rows, row stride V) rounded to bf16 and
// transposed into wt (n x d, d even): 64 x 64 tiles through shared memory,
// read along w's rows and written along wt's
template <typename TW>
__global__ void __launch_bounds__(256)
flce_cast_t_kernel(const TW* __restrict__ w, int V, int v0, int n, int d,
                   bf16* __restrict__ wt) {
  __shared__ __align__(16) bf16 tile[64][66];   // [column][k]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int k = (tid >> 6) + 4 * e, c = tid & 63;
    const float v = k0 + k < d && c0 + c < n
        ? ft5::to_float(w[static_cast<size_t>(k0 + k) * V + v0 + c0 + c])
        : 0.f;
    tile[c][k] = __float2bfloat16_rn(v);
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = (tid >> 5) + 8 * e, k = 2 * (tid & 31);
    if (c0 + c < n && k0 + k < d)
      *reinterpret_cast<uint32_t*>(wt + static_cast<size_t>(c0 + c) * d +
                                   k0 + k) =
          *reinterpret_cast<const uint32_t*>(&tile[c][k]);
  }
}

template <int kForm>
cudaError_t run_fwd(const CUtensorMap& tmx, const CUtensorMap& tmw, float* pm,
                    float* pse, float* psl, int rows, int d, int n, int per,
                    int split0, int n_split, float scale, int smooth,
                    cudaStream_t s) {
  auto kernel = flce_fwd_wgmma_kernel<kForm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<kForm>::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((rows + kBM - 1) / kBM, n_split), kThreads,
           Ring<kForm>::kSmem, s>>>(tmx, tmw, pm, pse, psl, rows, d, n, per,
                                    split0, scale, smooth);
  return cudaGetLastError();
}

// With a scratch wt: the vocabulary in slabs of `slab` columns; for each,
// its w^T in bf16 into wt, then the forward kernel over it with `per`
// vocab tiles a split, its splits' partials after the previous slabs'.
// Without one (an f32 w with 16-byte rows): one pass converting w's tiles
// in shared memory. `splits` must be their total
// (ops/fused_linear_ce.py::fwd_plan).
template <typename TW>
cudaError_t launch_fwd_wgmma(const bf16* x, const TW* w, bf16* wt, float* pm,
                             float* pse, float* psl, int rows, int d, int V,
                             int splits, int slab, int per, float scale,
                             int smooth, cudaStream_t s) {
  const bool convert = wt == nullptr;
  if (d % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 || slab <= 0 || per <= 0 ||
      (convert && (!std::is_same<TW, float>::value || V % 4 != 0 ||
                   reinterpret_cast<uintptr_t>(w) % 16 != 0 || slab < V)))
    return cudaErrorInvalidValue;
  int total = 0;
  for (int v0 = 0; v0 < V; v0 += slab)
    total += ((std::min(slab, V - v0) + kBN - 1) / kBN + per - 1) / per;
  if (total != splits) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  CUtensorMap tmx, tmw;
  if (!ft5::mma::make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, rows, d,
                          2, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  if (convert) {
    if (!ft5::mma::make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, d, V,
                            4, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_NONE))
      return cudaErrorInvalidValue;
    return run_fwd<kConvert>(tmx, tmw, pm, pse, psl, rows, d, V, per, 0,
                             splits, scale, smooth, s);
  }
  const bool resident = (d + kBK - 1) / kBK <= kResidentSteps;
  cudaError_t err = cudaSuccess;
  int split0 = 0;
  for (int v0 = 0; v0 < V && err == cudaSuccess; v0 += slab) {
    const int n = std::min(slab, V - v0);
    flce_cast_t_kernel<TW><<<dim3((n + 63) / 64, (d + 63) / 64), 256, 0, s>>>(
        w, V, v0, n, d, wt);
    if ((err = cudaGetLastError()) != cudaSuccess) break;
    if (!ft5::mma::make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wt, n, d,
                            2, kBN, kBK, CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorInvalidValue;
    const int n_split = ((n + kBN - 1) / kBN + per - 1) / per;
    err = resident ? run_fwd<kResident>(tmx, tmw, pm, pse, psl, rows, d, n,
                                        per, split0, n_split, scale, smooth,
                                        s)
                   : run_fwd<kStream>(tmx, tmw, pm, pse, psl, rows, d, n, per,
                                      split0, n_split, scale, smooth, s);
    split0 += n_split;
  }
  return err;
}

}  // namespace tma

// The f32 backward's chunks of d: ceil(d / 512) of them, each NCH blocks
// of 64 columns (the last chunk masked where d ends inside it)
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
cudaError_t reduce_dx(const float* part, float* dx_acc, T* dx, size_t n,
                      int splits, bool first, bool last,
                      cudaStream_t stream) {
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  flce_dx_reduce_kernel<T><<<blocks, 256, 0, stream>>>(part, dx_acc, dx, n,
                                                       splits, first, last);
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
      err = reduce_dx(dx_part, nullptr, static_cast<float*>(dx),
                      static_cast<size_t>(rows) * d, splits, true, true,
                      stream);
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

// ---------------------------------------------------------------------------
// the bf16 backward: dlogits once into a workspace, then two GEMMs
// ---------------------------------------------------------------------------
//
// flce_gemm_kernel computes C = A B for a (kGBM x kGBN) tile of C per CTA,
// kGWarpsM x kGWarpsN warps of (kWTM x kWTN), K in steps of kGK through a
// ring of kGStages buffers in shared memory: cp.async keeps the next steps'
// tiles in flight while the warps run mma.sync m16n8k16 on this step's. A
// and B are bf16, each staged in its natural layout, [rows][K] or
// [K][rows], and ldmatrix (transposed where the layout asks for it) reads
// the fragments; an operand whose rows are not 16-byte aligned (x at a d
// that is not a multiple of 8) is loaded through registers instead, 8
// elements a thread, masked. blockIdx.z takes a slice of K (a split). The
// epilogue `Epi` receives the f32 sums pair by pair: Epi::Row row(r) once
// per row of C, then pair(row_ctx, r, c, C[r][c], C[r][c + 1]) for even c.
// An epilogue that writes bf16 (kStaged) gets the ring's shared memory as a
// (kGBM x kGBN + 8) bf16 tile to write its pairs into, then flush() copies
// the tile out in 16-byte rows (a pair of bf16 is 4 bytes: written
// straight from the accumulators, a warp's stores would fill half of each
// 32-byte sector they touch).

constexpr int kGBM = 128, kGBN = 128;   // C tile
constexpr int kGK = 64;                  // K step
constexpr int kGWarpsM = 2, kGWarpsN = 4;
constexpr int kGThreads = 32 * kGWarpsM * kGWarpsN;
constexpr int kWTM = kGBM / kGWarpsM, kWTN = kGBN / kGWarpsN;  // warp tile
constexpr int kGStages = 3;

// One operand's (R x C) bf16 tile of a K step, C contiguous, in each
// stage, row stride C + 8 (16-byte rows apart by 16 mod 128 bytes:
// ldmatrix reads no bank twice).
template <int R, int C>
struct Operand {
  static constexpr int kStageBytes = R * (C + 8) * 2;
  bf16* base;                                 // stage 0
  bool async;                                 // rows 16-byte aligned

  __device__ bf16* tile(int stage) const {
    return base + stage * (kStageBytes / 2);
  }
  // the step's tile from src (row stride ld; rows >= n_rows and columns
  // >= n_cols read 0) into `stage`: cp.async when the rows are aligned,
  // else through registers (a synchronous store)
  __device__ void issue(int stage, const bf16* src, size_t ld, int n_rows,
                        int n_cols) const {
    bf16* t = tile(stage);
    for (int idx = threadIdx.x; idx < R * C / 8; idx += kGThreads) {
      const int r = idx / (C / 8), c = (idx % (C / 8)) * 8;
      const int valid = r < n_rows ? max(0, min(8, n_cols - c)) : 0;
      if (async)
        ft5::mma::cp_async16(t + r * (C + 8) + c,
                             valid ? src + r * ld + c : src, 2 * valid);
      else
        *reinterpret_cast<uint4*>(t + r * (C + 8) + c) =
            valid ? load8(src + r * ld + c, valid, false)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

template <bool kAT, bool kBT>
constexpr int gemm_smem_bytes() {
  return kGStages *
         (Operand<kAT ? kGK : kGBM, kAT ? kGBM : kGK>::kStageBytes +
          Operand<kBT ? kGBN : kGK, kBT ? kGK : kGBN>::kStageBytes);
}

// A = (M x K): kAT false stores it [m][k] (lda between rows m), true
// [k][m] (lda between rows k); B = (K x N): kBT false [k][n], true [n][k].
template <bool kAT, bool kBT, typename Epi>
__global__ void __launch_bounds__(kGThreads)
flce_gemm_kernel(const bf16* __restrict__ a, size_t lda, bool a_vec,
                 const bf16* __restrict__ b, size_t ldb, bool b_vec, int M,
                 int N, int K, int k_split, Epi epi) {
  constexpr int kAR = kAT ? kGK : kGBM, kAC = kAT ? kGBM : kGK;
  constexpr int kBR = kBT ? kGBN : kGK, kBC = kBT ? kGK : kGBN;
  using OpA = Operand<kAR, kAC>;
  using OpB = Operand<kBR, kBC>;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const OpA oa{smem, a_vec};
  const OpB ob{smem + kGStages * (OpA::kStageBytes / 2), b_vec};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / kGWarpsN) * kWTM, wn = (warp % kGWarpsN) * kWTN;
  const int m0 = blockIdx.x * kGBM, n0 = blockIdx.y * kGBN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kGK - 1) / kGK : 0;

  auto issue = [&](int t) {       // step t into stage t % kGStages
    const int st = t % kGStages, k0 = k_begin + t * kGK;
    if (kAT)
      oa.issue(st, a + static_cast<size_t>(k0) * lda + m0, lda, k_end - k0,
               M - m0);
    else
      oa.issue(st, a + static_cast<size_t>(m0) * lda + k0, lda, M - m0,
               k_end - k0);
    if (kBT)
      ob.issue(st, b + static_cast<size_t>(n0) * ldb + k0, ldb, N - n0,
               k_end - k0);
    else
      ob.issue(st, b + static_cast<size_t>(k0) * ldb + n0, ldb, k_end - k0,
               N - n0);
  };

  float acc[kWTM / 16][kWTN / 8][4];
#pragma unroll
  for (int i = 0; i < kWTM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWTN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kGStages - 1; ++t) {
    if (t < n_steps) issue(t);
    ft5::mma::cp_async_commit();
  }
  for (int t = 0; t < n_steps; ++t) {
    const int st = t % kGStages;
    ft5::mma::cp_async_wait<kGStages - 2>();
    __syncthreads();              // step t landed; step t - 1 fully read
    if (t + kGStages - 1 < n_steps) issue(t + kGStages - 1);
    ft5::mma::cp_async_commit();
    const bf16* at = oa.tile(st);
    const bf16* bt = ob.tile(st);
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      uint32_t af[kWTM / 16][4], bfr[kWTN / 16][4];
#pragma unroll
      for (int i = 0; i < kWTM / 16; ++i) {
        const int r0 = wm + 16 * i;
        if (kAT)
          ldsm_x4_t(af[i], at + (kk + (lane & 7) + 8 * (lane >> 4)) *
                                    (kAC + 8) + r0 + 8 * ((lane >> 3) & 1));
        else
          ldsm_x4(af[i], at + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                  (kAC + 8) + kk + 8 * (lane >> 4));
      }
#pragma unroll
      for (int jp = 0; jp < kWTN / 16; ++jp) {
        const int c0 = wn + 16 * jp;
        if (kBT)
          ldsm_x4(bfr[jp], bt + (c0 + (lane & 7) + 8 * (lane >> 4)) *
                                    (kBC + 8) + kk + 8 * ((lane >> 3) & 1));
        else
          ldsm_x4_t(bfr[jp], bt + (kk + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                      (kBC + 8) + c0 + 8 * (lane >> 4));
      }
#pragma unroll
      for (int i = 0; i < kWTM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWTN / 8; ++j)
          mma_bf16(acc[i][j], af[i], bfr[j >> 1] + 2 * (j & 1));
    }
  }
  ft5::mma::cp_async_wait<0>();
  if constexpr (Epi::kStaged) __syncthreads();   // the ring is free

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < kWTM / 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
      const typename Epi::Row row = epi.row(r);
#pragma unroll
      for (int j = 0; j < kWTN / 8; ++j) {
        const int c = n0 + wn + 8 * j + 2 * tq;
        epi.pair(row, r, c, acc[i][j][2 * h], acc[i][j][2 * h + 1],
                 smem + (r - m0) * (kGBN + 8) + c - n0);
      }
    }
  if constexpr (Epi::kStaged) {
    __syncthreads();              // the tile is written
    epi.flush(smem, m0, n0, M);
  }
}

// logits (a chunk's rows x a slab's columns) -> bf16 dlogits in the
// workspace (ld columns a row; the slab's columns from n to ld get 0), in
// the TPU kernel's order of operations (dlogit above); c_off is the slab's
// first vocabulary column
struct DlogitsEpi {
  static constexpr bool kStaged = true;
  Grad g;
  int r0, rows, c_off, n, ld;      // the chunk's first row; all rows
  bf16* ws;
  using Row = RowGrad;
  __device__ __forceinline__ Row row(int r) const {
    return row_grad(g, r0 + r, rows);
  }
  __device__ __forceinline__ void pair(const Row& q, int, int c, float v0,
                                       float v1, bf16* tile) const {
    const float d0 =
        c < n ? dlogit(g, q, v0 * g.logit_scale, c_off + c) : 0.f;
    const float d1 =
        c + 1 < n ? dlogit(g, q, v1 * g.logit_scale, c_off + c + 1) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(tile) = __floats2bfloat162_rn(d0, d1);
  }
  __device__ __forceinline__ void flush(const bf16* tile, int m0, int n0,
                                        int M) const {
    for (int idx = threadIdx.x; idx < kGBM * kGBN / 8; idx += kGThreads) {
      const int r = idx / (kGBN / 8), c = (idx % (kGBN / 8)) * 8;
      if (m0 + r < M && n0 + c < ld)
        *reinterpret_cast<uint4*>(ws + static_cast<size_t>(m0 + r) * ld +
                                  n0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * (kGBN + 8) + c);
    }
  }
};

// dx partial sums of split blockIdx.z of one slab: part (splits x rows x d)
struct DxEpi {
  static constexpr bool kStaged = false;
  float* part;
  int rows, d;
  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void pair(Row, int r, int c, float v0,
                                       float v1, bf16*) const {
    if (c >= d) return;
    float* p = part + (static_cast<size_t>(blockIdx.z) * rows + r) * d + c;
    if (c + 1 < d && d % 2 == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (c + 1 < d) p[1] = v1;
    }
  }
};

// dW's columns of one slab (n of them, row stride ld) += this row chunk's
// sums, in chunk order: the first chunk starts from 0, the last writes w's
// dtype; the sums between live in `acc` (f32, dw itself for an f32 lm_head)
template <typename TW>
struct DwEpi {
  static constexpr bool kStaged = false;
  float* acc;
  TW* dw;
  int n, ld;
  bool first, last;
  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void pair(Row, int r, int c, float v0,
                                       float v1, bf16*) const {
    if (c >= n) return;
    const size_t o = static_cast<size_t>(r) * ld + c;
    if (c + 1 < n && ld % 2 == 0 &&
        reinterpret_cast<uintptr_t>(dw + o) % (2 * sizeof(TW)) == 0) {
      float2 s = make_float2(v0, v1);
      if (!first) {
        const float2 a = *reinterpret_cast<const float2*>(acc + o);
        s.x += a.x;
        s.y += a.y;
      }
      if (!last)
        *reinterpret_cast<float2*>(acc + o) = s;
      else if constexpr (std::is_same<TW, float>::value)
        *reinterpret_cast<float2*>(dw + o) = s;
      else
        *reinterpret_cast<__nv_bfloat162*>(dw + o) =
            __floats2bfloat162_rn(s.x, s.y);
      return;
    }
    const float v[2] = {v0, v1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (c + e >= n) break;
      const float s = first ? v[e] : acc[o + e] + v[e];
      if (last)
        dw[o + e] = ft5::from_float<TW>(s);
      else
        acc[o + e] = s;
    }
  }
};

// w's columns [v0, v0 + n) (d rows, row stride V) rounded to bf16 into wb
// (d x ld, ld >= n a multiple of 8; the columns from n to ld get 0)
template <typename TW>
__global__ void flce_cast_slab_kernel(const TW* __restrict__ w, int V, int v0,
                                      int n, int ld, int d,
                                      bf16* __restrict__ wb) {
  const size_t n8 = static_cast<size_t>(d) * (ld / 8);
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < n8; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e / (ld / 8));
    const int c = static_cast<int>(e % (ld / 8)) * 8;
    const TW* src = w + static_cast<size_t>(k) * V + v0 + c;
    const bool vec = (V * sizeof(TW)) % 16 == 0 &&
                     ((v0 + c) * sizeof(TW)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    *reinterpret_cast<uint4*>(wb + static_cast<size_t>(k) * ld + c) =
        n - c > 0 ? load8(src, n - c, vec) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <bool kAT, bool kBT, typename Epi>
cudaError_t gemm(const bf16* a, size_t lda, bool a_vec, const bf16* b,
                 size_t ldb, bool b_vec, int M, int N, int K, int splits,
                 const Epi& epi, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int k_split = ((K + splits - 1) / splits + kGK - 1) / kGK * kGK;
  constexpr int smem = gemm_smem_bytes<kAT, kBT>();
  auto kernel = flce_gemm_kernel<kAT, kBT, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kGBM - 1) / kGBM, (N + kGBN - 1) / kGBN, splits);
  kernel<<<grid, kGThreads, smem, stream>>>(a, lda, a_vec, b, ldb, b_vec, M,
                                            N, K, k_split, epi);
  return cudaGetLastError();
}

// The bf16 backward, row chunk by row chunk (`chunk` rows) and, in each,
// vocabulary slab by slab (`slab` columns): (0) the slab of w rounded to
// bf16 into wb (skipped for a bf16 w with 16-byte rows, read in place);
// (1) the slab's dlogits into dl (chunk x slab bf16) from its logits,
// computed once; (2) dW[:, slab] (+)= x[chunk]^T dl, complete over the
// chunk's rows; (3) dx[chunk] += dl wb^T, K = the slab cut into `splits`
// slices whose f32 partials (part) flce_dx_reduce_kernel adds in order to
// the slabs' f32 sums (dx_acc, needed with more than one slab).
template <typename TW>
cudaError_t launch_bwd_gemm(const bf16* x, const TW* w, const Grad& g,
                            bf16* dl, bf16* wb, float* part, float* dx_acc,
                            float* dw_acc, bf16* dx, TW* dw, int rows, int d,
                            int V, int chunk, int slab, int splits,
                            cudaStream_t s) {
  const bool x_vec = rows_aligned(x, d);
  const bool in_place =
      std::is_same<TW, bf16>::value && rows_aligned(w, V) && slab % 8 == 0;
  const int n_chunks = (rows + chunk - 1) / chunk;
  const int n_slabs = (V + slab - 1) / slab;
  float* acc = std::is_same<TW, float>::value
                   ? reinterpret_cast<float*>(dw) : dw_acc;
  if ((n_chunks > 1 && acc == nullptr) || (n_slabs > 1 && dx_acc == nullptr) ||
      (!in_place && wb == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
    const int r0 = c * chunk, rc = std::min(chunk, rows - r0);
    const bf16* xc = x + static_cast<size_t>(r0) * d;
    for (int sl = 0; sl < n_slabs; ++sl) {
      const int v0 = sl * slab, n = std::min(slab, V - v0);
      const bf16* wt;
      int ldw;
      if (in_place) {
        wt = reinterpret_cast<const bf16*>(w) + v0;
        ldw = V;
      } else {
        ldw = (n + 7) / 8 * 8;
        const size_t n8 = static_cast<size_t>(d) * (ldw / 8);
        flce_cast_slab_kernel<TW>
            <<<static_cast<int>(std::min<size_t>((n8 + 255) / 256, 4096)),
               256, 0, s>>>(w, V, v0, n, ldw, d, wb);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
        wt = wb;
      }
      err = gemm<false, false>(xc, d, x_vec, wt, ldw, true, rc, n, d, 1,
                                     DlogitsEpi{g, r0, rows, v0, n, slab, dl},
                                     s);
      if (err != cudaSuccess) return err;
      err = gemm<true, false>(
          xc, d, x_vec, dl, slab, true, d, n, rc, 1,
          DwEpi<TW>{acc ? acc + v0 : nullptr, dw + v0, n, V, c == 0,
                    c == n_chunks - 1}, s);
      if (err != cudaSuccess) return err;
      err = gemm<false, true>(dl, slab, true, wt, ldw, true, rc, d, n,
                                    splits, DxEpi{part, rc, d}, s);
      if (err != cudaSuccess) return err;
      err = reduce_dx(part, dx_acc, dx + static_cast<size_t>(r0) * d,
                      static_cast<size_t>(rc) * d, splits, sl == 0,
                      sl == n_slabs - 1, s);
      if (err != cudaSuccess) return err;
    }
  }
  return err;
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

// The vocab splits of the forward (backward = 0) or of the f32 dx kernel
// (backward = 1, whose CTAs also split d into chunks) for `rows` x `V`.
FT5_EXPORT int ft5_flce_splits(int rows, int d, int V, int backward) {
  return n_splits(rows, V, backward ? chunks_of(d).n : 1);
}

// Partial (max, sum of exp, sum of logits) of each row over each split:
// x (rows, d) f32 or bf16 (`x_dtype`); w (d, V) in x's dtype, or f32 when
// `w_f32`; part_* (splits, rows) f32. With slab > 0, bf16 activations
// take the TMA + wgmma form (d a multiple of 8, x 16-byte aligned; `per`
// vocab tiles a split; `splits` as ops/fused_linear_ce.py::fwd_plan counts
// them): given a scratch `wt` (bf16, at least min(slab, V) x d), over
// vocab slabs of `slab` columns; given none (an f32 w with 16-byte rows,
// slab >= V), converting w in shared memory. With slab 0, the mma.sync
// form (ft5_flce_splits's splits).
FT5_EXPORT int ft5_flce_fwd(const void* x, const void* w, void* wt,
                            float* part_m, float* part_se, float* part_sl,
                            int rows, int d, int V, int splits, int slab,
                            int per, int x_dtype, int w_f32,
                            float logit_scale, int smooth, void* stream) {
  if (d <= 0 || V <= 0 || splits <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ft5::kFloat32 && !w_f32 && slab == 0)
    return launch_fwd_f32(static_cast<const float*>(x),
                          static_cast<const float*>(w), part_m, part_se,
                          part_sl, rows, d, V, splits, logit_scale, smooth,
                          s);
  if (x_dtype != ft5::kBFloat16) return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* wtb = static_cast<bf16*>(wt);
  if (slab > 0)
    return w_f32 ? tma::launch_fwd_wgmma(xb, static_cast<const float*>(w),
                                         wtb, part_m, part_se, part_sl, rows,
                                         d, V, splits, slab, per,
                                         logit_scale, smooth, s)
                 : tma::launch_fwd_wgmma(xb, static_cast<const bf16*>(w),
                                         wtb, part_m, part_se, part_sl, rows,
                                         d, V, splits, slab, per,
                                         logit_scale, smooth, s);
  return w_f32 ? launch_fwd_mma(xb, static_cast<const float*>(w), part_m,
                                part_se, part_sl, rows, d, V, splits,
                                logit_scale, smooth, s)
               : launch_fwd_mma(xb, static_cast<const bf16*>(w), part_m,
                                part_se, part_sl, rows, d, V, splits,
                                logit_scale, smooth, s);
}

// lse and the row sum of the logits from the first `n_merge` of the
// `stride` splits in part_*.
FT5_EXPORT int ft5_flce_merge(const float* part_m, const float* part_se,
                              const float* part_sl, float* lse, float* total,
                              int rows, int stride, int n_merge,
                              void* stream) {
  if (n_merge < 0 || n_merge > stride) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  flce_merge_kernel<<<(rows + 7) / 8, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      part_m, part_se, part_sl, lse, total, rows, n_merge);
  return cudaGetLastError();
}

// The f32 backward: dx (rows, d) and dw (d, V) f32; dx_part is (splits,
// rows, d) f32 scratch; labels int32, lse, dloss, dz (rows,) f32. (x_dtype
// and w_f32 must name f32 activations and weight: bf16 activations take
// ft5_flce_bwd_mma.)
FT5_EXPORT int ft5_flce_bwd(const void* x, const void* w, const int* labels,
                            const float* lse, const float* dloss,
                            const float* dz, float* dx_part, void* dx,
                            void* dw, int rows, int d, int V, int splits,
                            int total_classes, int ignore_index, int smooth,
                            int x_dtype, int w_f32, float logit_scale,
                            float lse_square_scale, float smoothing,
                            void* stream) {
  if (d <= 0 || V <= 0 || splits <= 0) return cudaErrorInvalidValue;
  if (x_dtype != ft5::kFloat32 || w_f32) return cudaErrorInvalidValue;
  const Grad g{labels, lse, dloss, dz, total_classes, ignore_index, smooth,
               logit_scale, lse_square_scale, smoothing};
  return dispatch_bwd_f32(d, x, w, g, dx_part, dx, dw, rows, V, splits,
                          static_cast<cudaStream_t>(stream));
}

// The bf16 backward (launch_bwd_gemm): x (rows, d) bf16; w (d, V) bf16,
// or f32 when w_f32; the workspace: dl (min(chunk, rows), slab) bf16, wb
// (d, slab) bf16 (null for a bf16 w with 16-byte rows), part (splits,
// min(chunk, rows), d) f32, dx_acc (min(chunk, rows), d) f32 (null with
// one slab); dw_acc (d, V) f32 for a bf16 w when rows > chunk, else null;
// dx (rows, d) bf16, dw like w; labels int32, lse, dloss, dz (rows,) f32.
// chunk and slab are multiples of 128.
FT5_EXPORT int ft5_flce_bwd_mma(
    const void* x, const void* w, const int* labels, const float* lse,
    const float* dloss, const float* dz, void* dl, void* wb, float* part,
    float* dx_acc, float* dw_acc, void* dx, void* dw, int rows, int d, int V,
    int chunk, int slab, int splits, int total_classes, int ignore_index,
    int smooth, int w_f32, float logit_scale, float lse_square_scale,
    float smoothing, void* stream) {
  if (d <= 0 || V <= 0 || chunk <= 0 || slab <= 0 || slab % 128 ||
      splits <= 0 || part == nullptr)
    return cudaErrorInvalidValue;
  const Grad g{labels, lse, dloss, dz, total_classes, ignore_index, smooth,
               logit_scale, lse_square_scale, smoothing};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* dlb = static_cast<bf16*>(dl);
  bf16* wbb = static_cast<bf16*>(wb);
  bf16* dxb = static_cast<bf16*>(dx);
  if (w_f32)
    return launch_bwd_gemm(xb, static_cast<const float*>(w), g, dlb, wbb,
                           part, dx_acc, dw_acc, dxb, static_cast<float*>(dw),
                           rows, d, V, chunk, slab, splits, s);
  return launch_bwd_gemm(xb, static_cast<const bf16*>(w), g, dlb, wbb, part,
                         dx_acc, dw_acc, dxb, static_cast<bf16*>(dw), rows, d,
                         V, chunk, slab, splits, s);
}
