// The bf16 flash attention kernels on Hopper's TMA and wgmma
// (FlashAttention-3's shape): the forward (fwd_wgmma_kernel) and the
// backward's dK/dV (dkdv_wgmma_kernel) and dQ (dq_wgmma_kernel) kernels, with
// a bias source: none, the T5 bucket table, or (the backward's) a bias
// tensor. They replace the mma.sync bodies of the port's earlier bf16
// kernels; the bias tensor's forward stays on attention.cuh's
// fwd_mma_kernel, which stages that bias faster (flash_attention_bias.cu),
// and f32 inputs take the CUDA-core forms.
//
// Every kernel is 384 threads: two consumer warpgroups (warps 0-7) and a
// producer warpgroup, which gives up its registers (setmaxnreg: 40 a
// thread, the consumers 232) and of which one warp works. Its lane 0 keeps
// TMA loads of the streamed tiles in flight through a 4-stage ring, each
// stage completing on its `full` mbarrier (32 arrivals: the warp's lanes,
// lane 0's carrying the bytes it expects) and freed by the 8 consumer
// warps' arrivals on its `empty` one; its 32 lanes also write what is
// gathered rather than copied into the stage: the bias window from the
// table, and the backward's lse and delta rows. The resident tile (Q, or Q
// and dO; K and V for dK/dV) is loaded once on a barrier of its own.
//
// The consumers follow FlashAttention-3's intra-warpgroup overlap: each
// warpgroup issues tile t's first products (S, or S and dP) together with
// tile t - 1's last ones (PV, dQ, or dV and dK), waits for the first and
// runs its softmax or dS on them while the others still run; the two
// warpgroups run free of each other (making them take turns at issuing,
// FlashAttention-3's ping-pong, ran 2-3% slower here). Exponentials are
// ex2.approx with the scale folded into one FMA.
//
// Tiles are TMA boxes of 64 bf16 columns (128-byte rows, 128-byte swizzle):
// a tile of R rows and D = 64 or 128 columns is D / 64 panels of R x 128
// bytes, one box each, read by wgmma K-major (wgmma_desc_sw128) or
// MN-major (wgmma_desc_sw128_mn). The maps are 3-D, (B H, rows, D), so a
// tile past the last row of a head reads zeros, never the next head. Head
// dims other than 64 and 128 are zero-padded by the wrappers.
//
// - fwd: a CTA per (128 query rows, head, batch); each consumer warpgroup
//   owns 64 rows. S = Q K^T is wgmma m64nBNk16 with Q and K from shared
//   memory (both K-major), the online softmax runs on the accumulator in
//   f32 in log2 units, P is rounded to
//   bf16 in registers and fed as wgmma's register A operand for O += P V,
//   V an MN-major B operand. BN = 128 keys at D 64, 64 at D 128.
// - dq: the forward's layout with Q and dO resident: S = Q K^T and dP =
//   dO V^T (both SS, K-major), dS = P (dP - delta) in f32 on the
//   accumulators, dQ += dS K with dS rounded to bf16 as the register A
//   operand and K MN-major. 64-key tiles.
// - dkdv: a CTA per (128 keys, head, batch); each consumer warpgroup owns
//   64 keys, K and V resident; Q and dO tiles of BQ query rows (64 at D 64,
//   32 at D 128) stream with their lse and delta. S^T = K Q^T and dP^T =
//   V dO^T (SS, K-major), P^T and dS^T in f32, dV += P^T dO and
//   dK += dS^T Q as RS products with dO and Q MN-major. With the table, dS
//   goes through a BQ x 132 f32 tile in shared memory and is summed along
//   its diagonals into per-offset sums and, at the end, into one row of dW
//   per CTA (attention.cuh's TableBias scheme, in a fixed order: the
//   outputs are bit-equal from run to run; no atomics anywhere). With the
//   bias tensor, dS goes from the registers to the per-batch dbias.
//
// Rounding points are attention.cuh's (the TPU kernels'): scores, P, dP and
// dS in f32, P and dS rounded to bf16 before their products, sums in f32,
// each output rounded once. Causal masking is bottom-right aligned; rows
// with no visible key give o = 0 and lse = -1e30 and contribute nothing to
// the backward.
//
// Bound on the H100: operations at the encoder's shape (the forward's 4 and
// the backward's 10 B H M N D flops in bf16: 0.0174 and 0.0434 ms at 989
// TFLOP/s for B 8, H 8, M = N = 1024, D 64), bytes at short ones.
#pragma once

#include "attention.cuh"

namespace ft5 {
namespace attn {
namespace wg {

using bf16 = __nv_bfloat16;
using namespace ft5::mma;

constexpr int kConsumerThreads = 256;           // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and the producer's
constexpr int kProducerWarp = 8;  // the producer warpgroup's working warp
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;   // registers a thread after setmaxnreg
constexpr int kConsumerRegs = 232;
constexpr int kRows = 128;      // query rows of a forward / dQ CTA
constexpr int kKeys = 128;      // keys of a dK/dV CTA
constexpr int kStages = 4;      // tiles t - 1 (products), t (S), and two
                                // loading (3 stages ran 3% slower)
constexpr int kPanel = 64;      // bf16 columns of a TMA box: 128 bytes
constexpr int kDqBN = 64;       // keys of a dQ tile
constexpr int kDsLd = kKeys + 4;  // row stride of dK/dV's dS tile (floats)
constexpr int kDsBarrier = 1;   // named barrier of dK/dV's dS tile

__host__ __device__ constexpr int round1k(int bytes) {
  return (bytes + 1023) / 1024 * 1024;
}
// an R-row tile of D bf16 columns: D / 64 panels of R x 128 bytes
__host__ __device__ constexpr int tile_bytes(int rows, int d) {
  return rows * d * 2;
}
template <int D>
__host__ __device__ constexpr int fwd_bn() { return D == 64 ? 128 : 64; }
template <int D>
__host__ __device__ constexpr int dkdv_bq() { return D == 64 ? 64 : 32; }

__device__ __forceinline__ uint8_t* align1k(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The T5 bias of the wgmma kernels: the (num_buckets, H) table read
// through the (M + N - 1,) int32 bucket of every offset col - row
// (bucket[col - row + M - 1], computed on the CPU), or no bias where the
// table is null. The producer warp gathers the table's column of the head
// once, then for each tile pair of R rows and C keys the R + C - 1 entries
// of the offsets it spans into the stage (entry jj - ii + R - 1 is the bias
// of row ii, key jj of the pair), every lane's bucket loads issued before
// its first shared-memory read. dw_part: the dK/dV kernel's dW rows.
struct TableW {
  const float* table;  // (num_buckets, H) f32, or null
  const int* bucket;   // (M + N - 1,) int32
  int num_buckets;     // 0 without a table
  float* dw_part;      // (B, H, ceil(N / kKeys), num_buckets) f32, or null

  __device__ void load_column(float* ws, int h, int H, int lane) const {
    for (int t = lane; t < num_buckets; t += 32) ws[t] = table[t * H + h];
  }
  // offsets j0 - i0 - (R - 1) .. j0 - i0 + C - 1; those outside
  // [-(M - 1), N - 1] only meet masked scores and are clamped
  template <int R, int C>
  __device__ void stage(float* win, const float* ws, int i0, int j0, int M,
                        int N, int lane) const {
    constexpr int kW = R + C - 1, kU = (kW + 31) / 32;
    int b[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = lane + 32 * u;
      const int gi = max(0, min(j0 - i0 - (R - 1) + t + M - 1, M + N - 2));
      b[u] = t < kW ? __ldg(bucket + gi) : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (lane + 32 * u < kW) win[lane + 32 * u] = ws[b[u]];
  }
};

// The bias tensor's source (the backward's): (B|1, H|1, M, N) f32 with a
// contiguous last axis, read through its batch, head and row strides (0 on
// a broadcast axis) by each consumer thread at its accumulator's
// coordinates, straight from device memory into registers (one instruction
// of a warp reads 8, or 4, rows of 32 contiguous bytes), a tile's entries
// as soon as the previous tile's scores are done with the registers, so
// that they land while S comes. dbias: the dK/dV kernel's
// per-batch (B, H, M, N) f32 dS, written from the registers the same way,
// or null.
struct TensorW {
  const float* ptr;      // the bias, or null
  long long sb, sh, sm;  // element strides of batch, head and row
  float* dbias;          // (B, H, M, N) f32, or null
  bool pairs;            // rows 8-byte aligned and N even: float2 reads

  __device__ const float* plane(int b, int h) const {
    return ptr + b * sb + h * sh;
  }
};

// the bias sources a kernel is built for
constexpr int kNoBias = 0, kTableBias = 1, kTensorBias = 2;

// the bias of the thread's rows r0 and r0 + 8, keys j0 + 8j + 2tq + e (a
// score tile's layout), 0 outside [0, M) x [0, N); each key pair in one
// 8-byte read where the rows allow it
template <int BN>
__device__ __forceinline__ void load_bias_rows(float (&bv)[BN / 2],
                                               const float* plane,
                                               long long sm, bool pairs,
                                               int r0, int j0, int tq, int M,
                                               int N) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    const float* p = plane + static_cast<long long>(min(row, M - 1)) * sm;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j0 + 8 * j + 2 * tq;
      if (pairs) {
        const float2 x = row < M && col < N
                             ? __ldg(reinterpret_cast<const float2*>(p + col))
                             : make_float2(0.f, 0.f);
        bv[4 * j + 2 * hh] = x.x;
        bv[4 * j + 2 * hh + 1] = x.y;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bv[4 * j + 2 * hh + e] =
              row < M && col + e < N ? __ldg(p + col + e) : 0.f;
      }
    }
  }
}
// the bias of query rows i0 + 8j + 2tq + e, keys c0 and c0 + 8 (the dK/dV
// kernel's transposed tile)
template <int BQ>
__device__ __forceinline__ void load_bias_cols(float (&bv)[BQ / 2],
                                               const float* plane,
                                               long long sm, int i0, int c0,
                                               int tq, int M, int N) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = i0 + 8 * j + 2 * tq + e;
      const float* p = plane + static_cast<long long>(min(row, M - 1)) * sm;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = c0 + 8 * hh;
        bv[4 * j + 2 * hh + e] = row < M && col < N ? __ldg(p + col) : 0.f;
      }
    }
}

// the producer's lanes arrive on a stage's `full` barrier; lane 0's arrival
// carries the bytes its TMA loads will complete
__device__ __forceinline__ void arrive_full(uint64_t* bar, int lane,
                                            int bytes) {
  if (lane == 0)
    mbar_expect_tx(bar, bytes);
  else
    mbar_arrive(bar);
}
// a consumer warp is done with a stage (its products have completed)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}
// the D / 64 panels of rows [r0, r0 + rows) of plane bh into dst
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int rows, int r0,
                                          int bh) {
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p)
    tma_load_3d(dst + p * rows * 128, m, bar, p * kPanel, r0, bh);
}
// K-major descriptor of the k16 step kk of a tile of `rows` rows, from row
// `r` (a multiple of 8) on
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int rows,
                                          int r, int kk) {
  return wgmma_desc_sw128(tile + (kk >> 2) * rows * 128 + r * 128 +
                          (kk & 3) * 32);
}
// MN-major descriptor of the k16 step kk (rows 16 kk ..) of a tile of
// `rows` rows
__device__ __forceinline__ uint64_t mndesc(const uint8_t* tile, int rows,
                                           int kk) {
  return wgmma_desc_sw128_mn(tile + kk * 2048, rows * 128);
}
// c (64 x N) = A B^T, both K-major with K = D: A the rows a_row0 .. + 63 of
// an a_rows-row tile, B an N-row tile
template <int N, int D>
__device__ __forceinline__ void ss_products(float (&c)[N / 2],
                                            const uint8_t* a, int a_rows,
                                            int a_row0, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<N>::template ss<0>(c, kdesc(a, a_rows, a_row0, kk),
                             kdesc(b, N, 0, kk), kk > 0);
}
// c (64 x D) += A B: A (64 x K) the register operand, B a K-row tile of D
// columns read MN-major
template <int D, int K>
__device__ __forceinline__ void rs_products(float (&c)[D / 2],
                                            const uint32_t (&a)[K / 16][4],
                                            const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    Wgmma<D>::template rs<1>(c, a[kk], mndesc(b, K, kk), 1);
}
// the accumulator's columns packed to bf16 as wgmma's register A operand:
// a[kk] holds columns 16 kk .. 16 kk + 15 of the thread's two rows
template <int R>
__device__ __forceinline__ void pack_a(const float (&acc)[R],
                                       uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The producer warpgroup gives up registers for the consumers' accumulators;
// its warps other than kProducerWarp leave at once. Returns whether the
// calling thread produces.
__device__ __forceinline__ bool split_roles(int warp) {
  if (warp >= kProducerWarp) {
    setmaxnreg_dec<kProducerRegs>();
    return true;
  }
  setmaxnreg_inc<kConsumerRegs>();
  return false;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kBN = fwd_bn<D>();
  static constexpr int kQ = tile_bytes(kRows, D);
  static constexpr int kK = tile_bytes(kBN, D);
  static constexpr int kWin = round1k((kRows + kBN - 1) * 4);
  static constexpr int kStage = 2 * kK + kWin;       // K, V, bias window
  static constexpr int kWs = kMaxBuckets * 4;
  static constexpr int kBytes =
      1024 + kQ + kStages * kStage + kWs + (2 * kStages + 1) * 8;
};

// The scores of one tile (s: the raw products of the thread's rows ii0 and
// ii0 + 8 of the CTA, keys j0 + 8j + 2tq + e) to P in f32, in place, and
// the running maxima m and sums l of the two rows updated, alpha set to the
// factor their earlier sums and outputs take. With the table's bias (its
// window win) a score is s * scale + bias by one FMA and m is in its units;
// without, m is in
// units of the raw products (the scale is positive, so their maximum is the
// scores'), and the scale joins log2(e) in c. Masks only on a tile that
// crosses N or the causal diagonal (kEdge). P = 2^(y c - m c), one FMA and
// one exponential on the special-function unit, without a bias; with one,
// 2^((y - m) c): a bias of -1e29 (ALiBi's masked halves) puts y and m
// near 1e29, where the unrounded product of an FMA would leave ulps of
// 1e29 in the exponent, and the difference is exact.
template <int BN, int kBias, bool kEdge>
__device__ __forceinline__ void online_softmax(
    float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const float* win, int ii0, int i0, int j0, int tq, int N, int causal,
    int offset, float sm_scale) {
  const float c = kBias != kNoBias ? kLog2e : sm_scale * kLog2e;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ii = ii0 + 8 * hh, row = i0 + ii;
    float mt[2] = {kNegInf, kNegInf};   // two chains: the keys' e
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = 8 * j + 2 * tq + e;
        float& y = s[4 * j + 2 * hh + e];
        if (kBias == kTableBias)
          y = fmaf(y, sm_scale, win[jj - ii + kRows - 1]);
        if (kEdge) {
          const int col = j0 + jj;
          if (!(col < N && (!causal || col <= row + offset))) y = kNegInf;
        }
        mt[e] = fmaxf(mt[e], y);
      }
    const float m_new = fmaxf(m[hh], quad_max(fmaxf(mt[0], mt[1])));
    alpha[hh] = fast_exp2((m[hh] - m_new) * c);
    const float mc = m_new * c;
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& y = s[4 * j + 2 * hh + e];
        const float p = kBias == kNoBias ? fast_exp2(fmaf(y, c, -mc))
                                         : fast_exp2((y - m_new) * c);
        // a row all masked so far has m_new -1e30 too: its P is 0
        y = (kEdge && !(y > kNegInf / 2)) ? 0.f : p;
        psum[e] += y;
      }
    l[hh] = l[hh] * alpha[hh] + quad_sum(psum[0] + psum[1]);
    m[hh] = m_new;
  }
}

// online_softmax on the form the tile needs
template <int BN, int kBias>
__device__ __forceinline__ void online_softmax_tile(
    bool edge, float (&s)[BN / 2], float (&m)[2], float (&l)[2],
    float (&alpha)[2], const float* win, int ii0, int i0, int j0, int tq,
    int N, int causal, int offset, float sm_scale) {
  if (edge)
    online_softmax<BN, kBias, true>(s, m, l, alpha, win, ii0, i0, j0, tq, N,
                                    causal, offset, sm_scale);
  else
    online_softmax<BN, kBias, false>(s, m, l, alpha, win, ii0, i0, j0, tq, N,
                                     causal, offset, sm_scale);
}

template <int D, int kBias>
__global__ void __launch_bounds__(kThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                 const __grid_constant__ CUtensorMap tmk,
                 const __grid_constant__ CUtensorMap tmv, TableW bias,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int M,
                 int N, float sm_scale, int causal) {
  using S = FwdSmem<D>;
  constexpr int kBN = S::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1k(smem_raw);
  uint8_t* ring = qs + S::kQ;
  float* ws = reinterpret_cast<float*>(ring + kStages * S::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kMaxBuckets);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y;
  const int bh = blockIdx.z * H + h;
  const int offset = N - M;                     // bottom-right causal
  int n_end = N;
  if (causal) n_end = max(0, min(N, i0 + kRows + offset));
  const int n_tiles = (n_end + kBN - 1) / kBN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (split_roles(warp)) {
    if (warp != kProducerWarp) return;
    if (kBias == kTableBias) {
      bias.load_column(ws, h, H, lane);
      __syncwarp();
    }
    if (lane == 0) {
      mbar_expect_tx(qbar, S::kQ);
      load_tile<D>(qs, &tmq, qbar, kRows, i0, bh);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
      uint8_t* stage = ring + st * S::kStage;
      if (kBias == kTableBias)
        bias.stage<kRows, kBN>(reinterpret_cast<float*>(stage + 2 * S::kK),
                               ws, i0, t * kBN, M, N, lane);
      arrive_full(&full[st], lane, 2 * S::kK);
      if (lane == 0) {
        load_tile<D>(stage, &tmk, &full[st], kBN, t * kBN, bh);
        load_tile<D>(stage + S::kK, &tmv, &full[st], kBN, t * kBN, bh);
      }
    }
    return;
  }

  const int wgi = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int rw = 64 * wgi + 16 * (warp & 3);    // the warp's first row
  float acc[D / 2], s[kBN / 2], alpha[2];
  uint32_t pa[kBN / 16][4];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBN / 2; ++r) s[r] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  auto edge = [&](int j0) {       // the tile masks some of the warp's rows
    return j0 + kBN > N || (causal && j0 + kBN - 1 > i0 + rw + offset);
  };
  auto window = [&](int st) {
    return reinterpret_cast<const float*>(ring + st * S::kStage + 2 * S::kK);
  };
  mbar_wait(qbar, 0);

  // Tile t's S = Q K^T is issued with tile t - 1's O += P V (FlashAttention-
  // 3's intra-warpgroup overlap): S first, so that its softmax runs while
  // the PV products still do; O takes its factor once they are done.
  if (n_tiles > 0) {
    mbar_wait(&full[0], 0);
    fence_all(s);
    wgmma_fence();
    ss_products<kBN, D>(s, qs, kRows, 64 * wgi, ring);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    online_softmax_tile<kBN, kBias>(edge(0), s, m_i, l_i, alpha, window(0),
                                    rw + g, i0, 0, tq, N, causal, offset,
                                    sm_scale);
    pack_a(s, pa);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages, ps = (t - 1) % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    fence_all(s);
    fence_all(acc);
    wgmma_fence();
    ss_products<kBN, D>(s, qs, kRows, 64 * wgi, ring + st * S::kStage);
    wgmma_commit();
    rs_products<D, kBN>(acc, pa, ring + ps * S::kStage + S::kK);
    wgmma_commit();
    wgmma_wait<1>();
    fence_all(s);
    online_softmax_tile<kBN, kBias>(edge(t * kBN), s, m_i, l_i, alpha,
                                    window(st), rw + g, i0, t * kBN, tq, N,
                                    causal, offset, sm_scale);
    wgmma_wait<0>();
    fence_all(acc);
    release(&empty[ps], lane);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[4 * j + r] *= alpha[r >> 1];
    pack_a(s, pa);
  }
  if (n_tiles > 0) {
    const int ps = (n_tiles - 1) % kStages;
    fence_all(acc);
    wgmma_fence();
    rs_products<D, kBN>(acc, pa, ring + ps * S::kStage + S::kK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(acc);
    release(&empty[ps], lane);
  }

  const size_t bhm = static_cast<size_t>(bh) * M;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + rw + g + 8 * hh;
    if (row >= M) continue;
    const float l_safe = l_i[hh] > 0.f ? l_i[hh] : 1.f;
    bf16* orow = o + (bhm + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
          pack_bf16(acc[4 * j + 2 * hh] / l_safe,
                    acc[4 * j + 2 * hh + 1] / l_safe);
    if (tq == 0)   // m_i in the units of online_softmax's
      lse[bhm + row] = l_i[hh] > 0.f
                           ? m_i[hh] * (kBias != kNoBias ? 1.f : sm_scale) +
                                 logf(l_safe)
                           : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kBN = kDqBN;
  static constexpr int kQ = tile_bytes(kRows, D);
  static constexpr int kK = tile_bytes(kBN, D);
  static constexpr int kWin = round1k((kRows + kBN - 1) * 4);
  static constexpr int kStage = 2 * kK + kWin;       // K, V, bias window
  static constexpr int kWs = kMaxBuckets * 4;
  static constexpr int kBytes =
      1024 + 2 * kQ + kStages * kStage + kWs + (2 * kStages + 1) * 8;
};

// dS = P (dP - delta) of one tile in f32, into s (online_softmax's
// layout): P = 2^(s c - lse log2(e)), c = scale log2(e), one FMA and one
// exponential, without a bias; 2^((s scale + bias - lse) log2(e)) with one
// (the difference first, as online_softmax's). l: the rows' lse, +1e30
// past M (P 0); a row that sees no key (lse -1e30) only meets masked tiles
// (kEdge).
template <int BN, int kBias, bool kEdge>
__device__ __forceinline__ void dq_scores(
    float (&s)[BN / 2], const float (&dp)[BN / 2], const float (&l)[2],
    const float (&dl)[2], const float* win, const float (&bv)[BN / 2],
    int ii0, int i0, int j0, int tq, int N, int causal, int offset,
    float sm_scale) {
  const float c = sm_scale * kLog2e;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ii = ii0 + 8 * hh, row = i0 + ii;
    const float lb = l[hh] * kLog2e;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = 8 * j + 2 * tq + e, col = j0 + jj;
        const float sv = s[4 * j + 2 * hh + e];
        float p;
        if (kBias == kNoBias) {
          p = fast_exp2(fmaf(sv, c, -lb));
        } else {
          const float b = kBias == kTableBias ? win[jj - ii + kRows - 1]
                                              : bv[4 * j + 2 * hh + e];
          p = fast_exp2((fmaf(sv, sm_scale, b) - l[hh]) * kLog2e);
        }
        if (kEdge && !(col < N && (!causal || col <= row + offset))) p = 0.f;
        s[4 * j + 2 * hh + e] = p * (dp[4 * j + 2 * hh + e] - dl[hh]);
      }
  }
}

template <int BN, int kBias>
__device__ __forceinline__ void dq_scores_tile(
    bool edge, float (&s)[BN / 2], const float (&dp)[BN / 2],
    const float (&l)[2], const float (&dl)[2], const float* win,
    const float (&bv)[BN / 2], int ii0, int i0, int j0, int tq, int N,
    int causal, int offset, float sm_scale) {
  if (edge)
    dq_scores<BN, kBias, true>(s, dp, l, dl, win, bv, ii0, i0, j0, tq, N,
                               causal, offset, sm_scale);
  else
    dq_scores<BN, kBias, false>(s, dp, l, dl, win, bv, ii0, i0, j0, tq, N,
                                causal, offset, sm_scale);
}

template <int D, int kBias>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, TableW bias, TensorW tb,
                bf16* __restrict__ dq, int H, int M, int N, float sm_scale,
                int causal) {
  using S = DqSmem<D>;
  constexpr int kBN = S::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1k(smem_raw);
  uint8_t* dos = qs + S::kQ;
  uint8_t* ring = dos + S::kQ;
  float* ws = reinterpret_cast<float*>(ring + kStages * S::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kMaxBuckets);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int i0 = blockIdx.x * kRows, h = blockIdx.y;
  const int bh = blockIdx.z * H + h;
  const int offset = N - M;
  int n_end = N;
  if (causal) n_end = max(0, min(N, i0 + kRows + offset));
  const int n_tiles = (n_end + kBN - 1) / kBN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (split_roles(warp)) {
    if (warp != kProducerWarp) return;
    if (kBias == kTableBias) {
      bias.load_column(ws, h, H, lane);
      __syncwarp();
    }
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * S::kQ);
      load_tile<D>(qs, &tmq, qbar, kRows, i0, bh);
      load_tile<D>(dos, &tmdo, qbar, kRows, i0, bh);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
      uint8_t* stage = ring + st * S::kStage;
      if (kBias == kTableBias)
        bias.stage<kRows, kBN>(reinterpret_cast<float*>(stage + 2 * S::kK),
                               ws, i0, t * kBN, M, N, lane);
      arrive_full(&full[st], lane, 2 * S::kK);
      if (lane == 0) {
        load_tile<D>(stage, &tmk, &full[st], kBN, t * kBN, bh);
        load_tile<D>(stage + S::kK, &tmv, &full[st], kBN, t * kBN, bh);
      }
    }
    return;
  }

  const int wgi = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int rw = 64 * wgi + 16 * (warp & 3);
  const size_t bhm = static_cast<size_t>(bh) * M;
  float l[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + rw + g + 8 * hh;
    l[hh] = row < M ? lse[bhm + row] : -kNegInf;
    dl[hh] = row < M ? delta[bhm + row] : 0.f;
  }
  float acc[D / 2], s[kBN / 2], dp[kBN / 2], bv[kBN / 2];
  uint32_t da[kBN / 16][4];
  const float* bplane =
      kBias == kTensorBias ? tb.plane(blockIdx.z, h) : nullptr;
  // the tensor's entries of tile t, read as soon as tile t - 1's softmax
  // is done with bv
  auto load_bias = [&](int t) {
    if (kBias == kTensorBias && t < n_tiles)
      load_bias_rows<kBN>(bv, bplane, tb.sm, tb.pairs, i0 + rw + g, t * kBN,
                          tq, M, N);
  };
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBN / 2; ++r) s[r] = dp[r] = 0.f;
  auto edge = [&](int j0) {
    return j0 + kBN > N || (causal && j0 + kBN - 1 > i0 + rw + offset);
  };
  auto window = [&](int st) {
    return reinterpret_cast<const float*>(ring + st * S::kStage + 2 * S::kK);
  };
  load_bias(0);
  mbar_wait(qbar, 0);

  // tile t's S = Q K^T and dP = dO V^T issued with tile t - 1's dQ += dS K
  if (n_tiles > 0) {
    mbar_wait(&full[0], 0);
    fence_all(s);
    fence_all(dp);
    wgmma_fence();
    ss_products<kBN, D>(s, qs, kRows, 64 * wgi, ring);
    ss_products<kBN, D>(dp, dos, kRows, 64 * wgi, ring + S::kK);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(s);
    fence_all(dp);
    dq_scores_tile<kBN, kBias>(edge(0), s, dp, l, dl, window(0), bv, rw + g,
                               i0, 0, tq, N, causal, offset, sm_scale);
    load_bias(1);
    pack_a(s, da);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages, ps = (t - 1) % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    fence_all(s);
    fence_all(dp);
    fence_all(acc);
    wgmma_fence();
    ss_products<kBN, D>(s, qs, kRows, 64 * wgi, ring + st * S::kStage);
    ss_products<kBN, D>(dp, dos, kRows, 64 * wgi,
                        ring + st * S::kStage + S::kK);
    wgmma_commit();
    rs_products<D, kBN>(acc, da, ring + ps * S::kStage);
    wgmma_commit();
    wgmma_wait<1>();
    fence_all(s);
    fence_all(dp);
    dq_scores_tile<kBN, kBias>(edge(t * kBN), s, dp, l, dl, window(st), bv,
                               rw + g, i0, t * kBN, tq, N, causal, offset,
                               sm_scale);
    load_bias(t + 1);
    wgmma_wait<0>();
    fence_all(acc);
    release(&empty[ps], lane);
    pack_a(s, da);
  }
  if (n_tiles > 0) {
    const int ps = (n_tiles - 1) % kStages;
    fence_all(acc);
    wgmma_fence();
    rs_products<D, kBN>(acc, da, ring + ps * S::kStage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(acc);
    release(&empty[ps], lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + rw + g + 8 * hh;
    if (row >= M) continue;
    bf16* dqrow = dq + (bhm + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dqrow + 8 * j + 2 * tq) =
          pack_bf16(acc[4 * j + 2 * hh] * sm_scale,
                    acc[4 * j + 2 * hh + 1] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV
// ---------------------------------------------------------------------------

template <int D>
struct DkdvSmem {
  static constexpr int kBQ = dkdv_bq<D>();
  static constexpr int kK = tile_bytes(kKeys, D);
  static constexpr int kQ = tile_bytes(kBQ, D);
  // lse, delta and the bias window of a query tile
  static constexpr int kRowsB = round1k((2 * kBQ + kBQ + kKeys - 1) * 4);
  static constexpr int kStage = 2 * kQ + kRowsB;     // Q, dO, rows
  static constexpr int kWs = kMaxBuckets * 4;
  static constexpr int kBars = 64;
  static constexpr int kDs = kBQ * kDsLd * 4;        // dS, with a table's dW
  // without the per-offset sums, whose size depends on M
  static constexpr int kFixed =
      1024 + 2 * kK + kStages * kStage + kBars + kWs;
  static __host__ __device__ int n_off(int M) {
    return (M + kBQ - 1) / kBQ * kBQ + kKeys - 1;
  }
};

// P^T and dS^T = P^T (dP^T - delta) of one tile in f32, P^T as dq_scores'
// P, into st and dpt (st[4j + 2hh + e] is key jj0 + 8hh of the CTA, query
// row 8j + 2tq + e of the tile); l_s: the rows' lse, +1e30 past M (P 0; a
// row that sees no key only meets masked tiles, kEdge); with keep_ds, the
// table's dS also into ds_s
// (query-major, row stride kDsLd), the tensor's into its dbias plane db
template <int BQ, int kBias, bool kEdge>
__device__ __forceinline__ void dkdv_scores(
    float (&st)[BQ / 2], float (&dpt)[BQ / 2], const float* l_s,
    const float* delta_s, const float* win, const float (&bv)[BQ / 2],
    float* ds_s, float* db, bool keep_ds, int jj0, int i0, int j0, int tq,
    int M, int N, int causal, int offset, float sm_scale) {
  const float c = sm_scale * kLog2e;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int ii = 8 * j + 2 * tq;
    const float2 l = *reinterpret_cast<const float2*>(l_s + ii);
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + ii);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jj = jj0 + 8 * hh, col = j0 + jj;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float le = e ? l.y : l.x;
        float& p = st[4 * j + 2 * hh + e];
        float& ds = dpt[4 * j + 2 * hh + e];
        if (kBias == kNoBias) {
          p = fast_exp2(fmaf(p, c, -le * kLog2e));
        } else {
          const float b = kBias == kTableBias ? win[jj - ii - e + BQ - 1]
                                              : bv[4 * j + 2 * hh + e];
          p = fast_exp2((fmaf(p, sm_scale, b) - le) * kLog2e);
        }
        if (kEdge && !(col < N && (!causal || col <= i0 + ii + e + offset)))
          p = 0.f;
        ds = p * (ds - (e ? dl.y : dl.x));
        if (kBias == kTableBias && keep_ds) ds_s[(ii + e) * kDsLd + jj] = ds;
        if (kBias == kTensorBias && keep_ds && i0 + ii + e < M && col < N)
          db[static_cast<size_t>(i0 + ii + e) * N + col] = ds;
      }
    }
  }
}

template <int BQ, int kBias>
__device__ __forceinline__ void dkdv_scores_tile(
    bool edge, float (&st)[BQ / 2], float (&dpt)[BQ / 2], const float* rows,
    const float (&bv)[BQ / 2], float* ds_s, float* db, bool keep_ds, int jj0,
    int i0, int j0, int tq, int M, int N, int causal, int offset,
    float sm_scale) {
  if (edge)
    dkdv_scores<BQ, kBias, true>(st, dpt, rows, rows + BQ, rows + 2 * BQ, bv,
                                 ds_s, db, keep_ds, jj0, i0, j0, tq, M, N,
                                 causal, offset, sm_scale);
  else
    dkdv_scores<BQ, kBias, false>(st, dpt, rows, rows + BQ, rows + 2 * BQ,
                                  bv, ds_s, db, keep_ds, jj0, i0, j0, tq, M,
                                  N, causal, offset, sm_scale);
}

template <int D, int kBias>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  const __grid_constant__ CUtensorMap tmdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, TableW bias, TensorW tb,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int M,
                  int N, float sm_scale, int causal) {
  using S = DkdvSmem<D>;
  constexpr int kBQ = S::kBQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1k(smem_raw);
  uint8_t* vs = ks + S::kK;
  uint8_t* ring = vs + S::kK;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * S::kStage);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;
  float* ws = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(full) + S::kBars);
  float* ds_s = ws + kMaxBuckets;             // kBQ x kDsLd, with dW
  float* doff = ds_s + kBQ * kDsLd;           // sums of dS by offset

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j0 = blockIdx.x * kKeys, h = blockIdx.y;
  const int bh = blockIdx.z * H + h;
  const int offset = N - M;
  // the table's dS for dW, or the tensor's for dbias
  const bool keep_ds = (kBias == kTableBias && bias.dw_part != nullptr) ||
                       (kBias == kTensorBias && tb.dbias != nullptr);
  // the first query tile with a row that sees a key of this CTA
  const int i_begin = causal ? max(0, j0 - offset) / kBQ * kBQ : 0;
  const int n_tiles = i_begin < M ? (M - i_begin + kBQ - 1) / kBQ : 0;
  const int Mp = (M + kBQ - 1) / kBQ * kBQ;  // doff[e]: offset e - (Mp - 1)
                                             // + j0

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(kvbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (split_roles(warp)) {
    if (warp != kProducerWarp) return;
    if (kBias == kTableBias) {
      bias.load_column(ws, h, H, lane);
      __syncwarp();
    }
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * S::kK);
      load_tile<D>(ks, &tmk, kvbar, kKeys, j0, bh);
      load_tile<D>(vs, &tmv, kvbar, kKeys, j0, bh);
    }
    const size_t bhm = static_cast<size_t>(bh) * M;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages, i0 = i_begin + t * kBQ;
      if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
      uint8_t* stage = ring + st * S::kStage;
      float* rows = reinterpret_cast<float*>(stage + 2 * S::kQ);
#pragma unroll
      for (int r = lane; r < kBQ; r += 32) {
        const int row = i0 + r;
        rows[r] = row < M ? lse[bhm + row] : -kNegInf;
        rows[kBQ + r] = row < M ? delta[bhm + row] : 0.f;
      }
      if (kBias == kTableBias)
        bias.stage<kBQ, kKeys>(rows + 2 * kBQ, ws, i0, j0, M, N, lane);
      arrive_full(&full[st], lane, 2 * S::kQ);
      if (lane == 0) {
        load_tile<D>(stage, &tmq, &full[st], kBQ, i0, bh);
        load_tile<D>(stage + S::kQ, &tmdo, &full[st], kBQ, i0, bh);
      }
    }
    return;
  }

  const int wgi = warp >> 2, g = lane >> 2, tq = lane & 3;
  const int kw = 64 * wgi + 16 * (warp & 3);    // the warp's first key
  float* db = nullptr;          // the tensor's dbias plane
  if (kBias == kTableBias && keep_ds) {
    for (int e = tid; e < S::n_off(M); e += kConsumerThreads) doff[e] = 0.f;
    named_sync(kDsBarrier, kConsumerThreads);
  }
  if (kBias == kTensorBias && keep_ds) {
    db = tb.dbias + static_cast<size_t>(bh) * M * N;
    // the rows above i_begin see none of the CTA's keys: their dS is 0
    for (int idx = tid; idx < i_begin * kKeys; idx += kConsumerThreads) {
      const int row = idx / kKeys, col = j0 + idx - row * kKeys;
      if (col < N) db[static_cast<size_t>(row) * N + col] = 0.f;
    }
  }
  const float* bplane =
      kBias == kTensorBias ? tb.plane(blockIdx.z, h) : nullptr;
  float dka[D / 2], dva[D / 2], st_[kBQ / 2], dpt[kBQ / 2], bv[kBQ / 2];
  // the tensor's entries of tile t, read as soon as tile t - 1's scores
  // are done with bv
  auto load_bias = [&](int t) {
    if (kBias == kTensorBias && t < n_tiles)
      load_bias_cols<kBQ>(bv, bplane, tb.sm, i_begin + t * kBQ, j0 + kw + g,
                          tq, M, N);
  };
  uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dka[r] = dva[r] = 0.f;
#pragma unroll
  for (int r = 0; r < kBQ / 2; ++r) st_[r] = dpt[r] = 0.f;
  // only the warp's keys at N's end or across the causal diagonal mask
  // single scores
  auto edge = [&](int i0) {
    return j0 + kw + 16 > N || (causal && j0 + kw + 15 > i0 + offset);
  };
  auto rows = [&](int st) {
    return reinterpret_cast<const float*>(ring + st * S::kStage + 2 * S::kQ);
  };
  // thread t sums diagonal t (jj - ii = t - (kBQ - 1)) of the tile's dS, in
  // row order, into its offset's sum, between two barriers of both
  // warpgroups (summing each warpgroup's half apart, between barriers of
  // its own, took longer)
  auto sink = [&](int i0) {
    named_sync(kDsBarrier, kConsumerThreads);   // the tile's dS is in ds_s
    for (int t2 = tid; t2 < kBQ + kKeys - 1; t2 += kConsumerThreads) {
      const int d0 = t2 - (kBQ - 1);
      float sum = 0.f;
      for (int ii = max(0, -d0); ii < kBQ && ii + d0 < kKeys; ++ii)
        sum += ds_s[ii * kDsLd + ii + d0];
      doff[d0 - i0 + Mp - 1] += sum;
    }
    named_sync(kDsBarrier, kConsumerThreads);   // ds_s free again
  };
  load_bias(0);
  mbar_wait(kvbar, 0);

  // tile t's S^T = K Q^T and dP^T = V dO^T issued with tile t - 1's dV +=
  // P^T dO and dK += dS^T Q
  if (n_tiles > 0) {
    mbar_wait(&full[0], 0);
    fence_all(st_);
    fence_all(dpt);
    wgmma_fence();
    ss_products<kBQ, D>(st_, ks, kKeys, 64 * wgi, ring);
    ss_products<kBQ, D>(dpt, vs, kKeys, 64 * wgi, ring + S::kQ);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(st_);
    fence_all(dpt);
    dkdv_scores_tile<kBQ, kBias>(edge(i_begin), st_, dpt, rows(0), bv, ds_s,
                                 db, keep_ds, kw + g, i_begin, j0, tq, M, N,
                                 causal, offset, sm_scale);
    load_bias(1);
    if (kBias == kTableBias && keep_ds) sink(i_begin);
    pack_a(st_, pa);
    pack_a(dpt, da);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int st = t % kStages, ps = (t - 1) % kStages;
    const int i0 = i_begin + t * kBQ;
    mbar_wait(&full[st], (t / kStages) & 1);
    fence_all(st_);
    fence_all(dpt);
    fence_all(dka);
    fence_all(dva);
    wgmma_fence();
    ss_products<kBQ, D>(st_, ks, kKeys, 64 * wgi, ring + st * S::kStage);
    ss_products<kBQ, D>(dpt, vs, kKeys, 64 * wgi,
                        ring + st * S::kStage + S::kQ);
    wgmma_commit();
    rs_products<D, kBQ>(dva, pa, ring + ps * S::kStage + S::kQ);
    rs_products<D, kBQ>(dka, da, ring + ps * S::kStage);
    wgmma_commit();
    wgmma_wait<1>();
    fence_all(st_);
    fence_all(dpt);
    dkdv_scores_tile<kBQ, kBias>(edge(i0), st_, dpt, rows(st), bv, ds_s, db,
                                 keep_ds, kw + g, i0, j0, tq, M, N, causal,
                                 offset, sm_scale);
    load_bias(t + 1);
    if (kBias == kTableBias && keep_ds) sink(i0);
    wgmma_wait<0>();
    fence_all(dka);
    fence_all(dva);
    release(&empty[ps], lane);
    pack_a(st_, pa);
    pack_a(dpt, da);
  }
  if (n_tiles > 0) {
    const int ps = (n_tiles - 1) % kStages;
    fence_all(dka);
    fence_all(dva);
    wgmma_fence();
    rs_products<D, kBQ>(dva, pa, ring + ps * S::kStage + S::kQ);
    rs_products<D, kBQ>(dka, da, ring + ps * S::kStage);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(dka);
    fence_all(dva);
    release(&empty[ps], lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = j0 + kw + g + 8 * hh;
    if (col >= N) continue;
    const size_t orow = (static_cast<size_t>(bh) * N + col) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + orow + 8 * j + 2 * tq) =
          pack_bf16(dka[4 * j + 2 * hh] * sm_scale,
                    dka[4 * j + 2 * hh + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(dv + orow + 8 * j + 2 * tq) =
          pack_bf16(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
    }
  }

  if (kBias != kTableBias || !keep_ds) return;
  // per-offset sums into buckets: `parts` threads per bucket each scan a
  // contiguous share of the offsets, then one thread adds the shares in
  // order (ds_s is the scratch)
  const int nb = bias.num_buckets, n = S::n_off(M);
  const int parts = max(1, kConsumerThreads / nb);
  for (int idx = tid; idx < nb * parts; idx += kConsumerThreads) {
    const int b = idx / parts, part = idx - b * parts;
    const int chunk = (n + parts - 1) / parts;
    const int e_end = min(n, (part + 1) * chunk);
    float sum = 0.f;
    for (int e = part * chunk; e < e_end; ++e) {
      const int gi = e - (Mp - 1) + j0 + M - 1;  // bucket index of offset
      if (gi >= 0 && gi <= M + N - 2 && bias.bucket[gi] == b) sum += doff[e];
    }
    ds_s[idx] = sum;
  }
  named_sync(kDsBarrier, kConsumerThreads);
  for (int b = tid; b < nb; b += kConsumerThreads) {
    float sum = 0.f;
    for (int p = 0; p < parts; ++p) sum += ds_s[b * parts + p];
    bias.dw_part[(static_cast<size_t>(bh) * gridDim.x + blockIdx.x) * nb +
                 b] = sum;
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a (B H, rows, D) bf16 array's map, boxes of box_rows x 64 columns
inline bool bf16_map(CUtensorMap* m, const void* p, int planes, int rows,
                     int d, int box_rows) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         make_map_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, planes, rows, d,
                     2, box_rows, kPanel, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename K, typename... Args>
cudaError_t launch_wg(K kernel, dim3 grid, int smem, cudaStream_t s,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// f(Dim<D>{}) for the wgmma kernels' head dims
template <typename F>
cudaError_t by_dim(int D, F f) {
  switch (D) {
    case 64: return f(Dim<64>{});
    case 128: return f(Dim<128>{});
    default: return cudaErrorInvalidValue;
  }
}

// The kernels on the bias source kBias (kNoBias; kTableBias, `bias`; or,
// the backward's, kTensorBias, `tb`). q (B,H,M,D), k and v (B,H,N,D), o
// like q, bf16, contiguous, 16-byte aligned; lse (B,H,M) f32; D 64 or 128;
// sm_scale > 0 (the forward takes the rows' maxima over the unscaled
// products).
template <int kBias>
cudaError_t launch_fwd(const TableW& bias, const void* q, const void* k,
                       const void* v, void* o, float* lse, int B, int H,
                       int M, int N, int D, float sm_scale, int causal,
                       void* stream) {
  if (M == 0) return cudaSuccess;
  if (N == 0 || !(sm_scale > 0.f)) return cudaErrorInvalidValue;
  return by_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    using S = FwdSmem<kD>;
    CUtensorMap tq, tk, tv;
    if (!bf16_map(&tq, q, B * H, M, kD, kRows) ||
        !bf16_map(&tk, k, B * H, N, kD, S::kBN) ||
        !bf16_map(&tv, v, B * H, N, kD, S::kBN))
      return cudaErrorInvalidValue;
    return launch_wg(fwd_wgmma_kernel<kD, kBias>,
                     dim3((M + kRows - 1) / kRows, H, B), S::kBytes,
                     static_cast<cudaStream_t>(stream), tq, tk, tv, bias,
                     static_cast<bf16*>(o), lse, H, M, N, sm_scale, causal);
  });
}

// the backward's dK/dV kernel: dW's rows where bias.dw_part is set ((B, H,
// ceil(N / kKeys), num_buckets)), the per-batch dbias where tb.dbias is;
// dout like q, lse and delta (B,H,M) f32
template <int kBias>
cudaError_t launch_dkdv(const TableW& bias, const TensorW& tb, const void* q,
                        const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk,
                        void* dv, int B, int H, int M, int N, int D,
                        float sm_scale, int causal, void* stream) {
  if (N == 0 || M == 0 || !(sm_scale > 0.f)) return cudaErrorInvalidValue;
  return by_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    using S = DkdvSmem<kD>;
    CUtensorMap tq, tk, tv, tdo;
    if (!bf16_map(&tq, q, B * H, M, kD, S::kBQ) ||
        !bf16_map(&tk, k, B * H, N, kD, kKeys) ||
        !bf16_map(&tv, v, B * H, N, kD, kKeys) ||
        !bf16_map(&tdo, dout, B * H, M, kD, S::kBQ))
      return cudaErrorInvalidValue;
    const bool dw = kBias == kTableBias && bias.dw_part != nullptr;
    const int smem = S::kFixed + (dw ? S::kDs + 4 * S::n_off(M) : 0);
    return launch_wg(dkdv_wgmma_kernel<kD, kBias>,
                     dim3((N + kKeys - 1) / kKeys, H, B), smem,
                     static_cast<cudaStream_t>(stream), tq, tk, tv, tdo, lse,
                     delta, bias, tb, static_cast<bf16*>(dk),
                     static_cast<bf16*>(dv), H, M, N, sm_scale, causal);
  });
}

// the backward's dQ kernel (the forward's tiles)
template <int kBias>
cudaError_t launch_dq(const TableW& bias, const TensorW& tb, const void* q,
                      const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int B,
                      int H, int M, int N, int D, float sm_scale, int causal,
                      void* stream) {
  if (N == 0 || M == 0 || !(sm_scale > 0.f)) return cudaErrorInvalidValue;
  return by_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    using S = DqSmem<kD>;
    CUtensorMap tq, tk, tv, tdo;
    if (!bf16_map(&tq, q, B * H, M, kD, kRows) ||
        !bf16_map(&tk, k, B * H, N, kD, S::kBN) ||
        !bf16_map(&tv, v, B * H, N, kD, S::kBN) ||
        !bf16_map(&tdo, dout, B * H, M, kD, kRows))
      return cudaErrorInvalidValue;
    TableW qbias = bias;
    qbias.dw_part = nullptr;
    return launch_wg(dq_wgmma_kernel<kD, kBias>,
                     dim3((M + kRows - 1) / kRows, H, B), S::kBytes,
                     static_cast<cudaStream_t>(stream), tq, tk, tv, tdo, lse,
                     delta, qbias, tb, static_cast<bf16*>(dq), H, M, N,
                     sm_scale, causal);
  });
}

// The MN-major operand alone: c (64 x N) = a (64 x 64, K-major) b (64 x N,
// row-major, so MN-major), N 64 or 128, by one warpgroup, once with A from
// shared memory (c_ss) and once with A from registers (c_rs). The card
// tests and chip_smoke.py hold it against torch.matmul.
template <int N>
__global__ void __launch_bounds__(128)
wgmma_mn_check_kernel(const __grid_constant__ CUtensorMap tma,
                      const __grid_constant__ CUtensorMap tmb,
                      const bf16* __restrict__ a, float* __restrict__ c_ss,
                      float* __restrict__ c_rs) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = align1k(smem_raw);
  uint8_t* bs = as + tile_bytes(64, 64);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bs + tile_bytes(64, N));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, tile_bytes(64, 64) + tile_bytes(64, N));
    tma_load_3d(as, &tma, bar, 0, 0, 0);
    load_tile<N>(bs, &tmb, bar, 64, 0, 0);
  }
  mbar_wait(bar, 0);
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r & 1);
      const int col = 16 * kk + 2 * tq + 8 * (r >> 1);
      af[kk][r] = *reinterpret_cast<const uint32_t*>(a + row * 64 + col);
    }
  float c1[N / 2], c2[N / 2];
#pragma unroll
  for (int r = 0; r < N / 2; ++r) c1[r] = c2[r] = 0.f;
  fence_all(c1);
  fence_all(c2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Wgmma<N>::template ss<1>(c1, kdesc(as, 64, 0, kk),
                             mndesc(bs, 64, kk), kk > 0);
    Wgmma<N>::template rs<1>(c2, af[kk], mndesc(bs, 64, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(c1);
  fence_all(c2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + 8 * (r >> 1);
      const int col = 8 * j + 2 * tq + (r & 1);
      c_ss[row * N + col] = c1[4 * j + r];
      c_rs[row * N + col] = c2[4 * j + r];
    }
}

inline cudaError_t launch_mn_check(const void* a, const void* b, float* c_ss,
                                   float* c_rs, int N, void* stream) {
  return by_dim(N, [&](auto d) {
    constexpr int kN = decltype(d)::value;
    CUtensorMap ta, tb;
    if (!bf16_map(&ta, a, 1, 64, 64, 64) || !bf16_map(&tb, b, 1, 64, kN, 64))
      return cudaErrorInvalidValue;
    const int smem = 1024 + tile_bytes(64, 64) + tile_bytes(64, kN) + 8;
    auto kernel = wgmma_mn_check_kernel<kN>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
        ta, tb, static_cast<const bf16*>(a), c_ss, c_rs);
    return cudaGetLastError();
  });
}

}  // namespace wg
}  // namespace attn
}  // namespace ft5
