// T5 RMS norm over the last axis of x (rows, d): the forward (y, rstd) and
// the backward (dx, dW) of flasht5_tpu_torch/ops/rmsnorm.py.
//
// Replaces the Pallas kernels flasht5_tpu/ops/rmsnorm.py::_fwd_kernel
// (launched by `_pallas_fwd`, :85) and ::_bwd_kernel (`_pallas_bwd`, :115).
// Arithmetic as there, all in fp32: rstd = rsqrt(mean(x^2) + eps) (rsqrtf,
// as `jax.lax.rsqrt` and `torch.rsqrt` on the card),
// y = x * rstd * w rounded once to x's type; x^ = x * rstd,
// dx = (w*dy - x^ * mean(w*dy*x^)) * rstd in dy's type, dW = sum_rows dy*x^.
// The weight is read as stored (f32, bf16 or f16) and widened to fp32, as
// the TPU kernel takes it. One runtime flag, `cast_w`, folds in the model's
// cast `w.to(x.dtype)`: w is rounded to x's type as it is loaded and dW to
// x's type as it is written (the cast's gradient), so the cast of an fp32
// parameter costs no launch.
//
// Bound on the H100: bytes. The forward reads x and writes y (and 4 bytes of
// rstd a row); the backward reads x, dy and rstd and writes dx; both do a
// handful of operations an element. What holds such a kernel back is too few
// bytes in flight and, in the backward, the sum over all rows that dW is:
//
// - Warp form (rows of up to 128 chunks: d <= 1024 in bf16): one warp a row.
//   A lane holds CPL chunks of the row, chunk j * 32 + lane, each a 16-byte
//   vector of x's type (a single element where d is not a multiple of the
//   vector or a tensor is not aligned). Row sums are five __shfl_xor_sync
//   steps: no shared memory, no barrier.
//   The forward gives every kFwdWarps rows a CTA and nothing else: the
//   block scheduler keeps as many rows in flight as the SMs hold, and each
//   warp reads its slice of w next to its row. (On the H100 this beat a
//   persistent grid with the next row in flight, with groups of rows, and
//   with a ring of bulk copies; see PERF.md.)
//   The backward's grid is persistent, sized from the card's SM count and
//   the kernel's occupancy: each warp strides over the rows with the next
//   row's loads in flight while it computes the current one, and keeps its
//   slice of w and its columns' dW sums in registers throughout. A few rows
//   (decode) take one CTA of one warp a row, each on its own SM.
// - CTA form (wider rows): one CTA a row, a thread holding kCtaChunks chunks
//   (chunk j * threads + thread), the warps' partial sums combined in shared
//   memory in warp order (one barrier a row, two buffers). Chunks beyond
//   what the CTA holds are read again from memory in the second pass.
// - The backward's dW, in the same launch and in a fixed order. The CTAs
//   form clusters of up to 8; CTA r of a cluster owns column slice r, and
//   every warp pushes its sums of each slice into the owner's shared memory
//   (st.async, completing on the owner's mbarrier), where they are added in
//   (CTA rank, warp) order; a grid of one cluster is done. Else each owner
//   writes its cluster's partial of the slice, takes an arrival ticket
//   (atom.acq_rel), and the last CTA of rank r adds slice r of the cluster
//   partials in cluster order and writes dW. (The CTA form's partials meet
//   through device memory and a cluster barrier instead.) Two launches give
//   the same bits; dW needs no second launch. The wrapper allocates the
//   partials (torch.empty) and keeps the tickets, which each launch's last
//   CTAs leave at zero.

#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include <algorithm>
#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFloat16 = 2;       // dtype code beside common.cuh's 0 and 1
constexpr int kWarpRows = 8;      // warps of a backward warp-form CTA
constexpr int kWarpChunks = 128;  // chunks a warp-form row holds at most
constexpr int kFwdWarps = 4;      // warps (rows) of a forward warp-form CTA
constexpr int kCtaChunks = 2;     // chunks a CTA-form thread holds
constexpr int kMaxCluster = 8;    // CTAs of a backward cluster (portable)
constexpr int kCtaThreads = 512;   // threads of a CTA-form CTA at most

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half cvt<__half>(float v) {
  return __float2half_rn(v);
}

// V consecutive elements, loaded and stored as one aligned access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// chunk i (in units of V elements) of an array of T
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const void* base, long long i) {
  return reinterpret_cast<const Vec<T, V>*>(base)[i];
}
template <typename T, int V>
__device__ __forceinline__ void store(void* base, long long i,
                                      const Vec<T, V>& v) {
  reinterpret_cast<Vec<T, V>*>(base)[i] = v;
}

// the same for data read or written once: streaming (evict-first) accesses
// where a chunk is one 16-byte vector
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_once(const void* base, long long i) {
  if constexpr (sizeof(Vec<T, V>) == 16) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(base) + i);
    return *reinterpret_cast<const Vec<T, V>*>(&u);
  } else {
    return load<T, V>(base, i);
  }
}
template <typename T, int V>
__device__ __forceinline__ void store_once(void* base, long long i,
                                           const Vec<T, V>& v) {
  if constexpr (sizeof(Vec<T, V>) == 16)
    __stcs(reinterpret_cast<uint4*>(base) + i,
           *reinterpret_cast<const uint4*>(&v));
  else
    store<T, V>(base, i, v);
}

// chunk c of w (stored as `code`) in fp32, rounded through x's type first
// where `cast` (the model's `w.to(x.dtype)`)
template <typename Tx, typename Tw, int V>
__device__ __forceinline__ Vec<float, V> load_w_as(const void* w, int c,
                                                   int cast) {
  const Vec<Tw, V> s = load<Tw, V>(w, c);
  Vec<float, V> out;
#pragma unroll
  for (int i = 0; i < V; ++i)
    out.v[i] = cast ? f32(cvt<Tx>(f32(s.v[i]))) : f32(s.v[i]);
  return out;
}
template <typename Tx, int V>
__device__ __forceinline__ Vec<float, V> load_w(const void* w, int code,
                                                int cast, int c) {
  if (code == ft5::kFloat32) return load_w_as<Tx, float, V>(w, c, cast);
  if (code == ft5::kBFloat16)
    return load_w_as<Tx, __nv_bfloat16, V>(w, c, cast);
  return load_w_as<Tx, __half, V>(w, c, cast);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Fwd {
  const void* x;
  const void* w;
  void* y;
  float* rstd;
  long long rows;
  int d, nchunks, w_code, cast_w;
  float eps;
};

struct Bwd {
  const void* x;
  const void* w;
  const float* rstd;
  const void* dy;
  void* dx;
  float* dw;
  float* part;      // (grid, d) CTA partials, then (clusters, d)
  int* tickets;     // (kMaxCluster,) arrival counts, zero between launches
  long long rows;
  int d, nchunks, w_code, cast_w;
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename Tx, int V, int CPL>
__device__ __forceinline__ float sum_sq(const Vec<Tx, V> (&xv)[CPL],
                                        int lane, int n) {
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (j * 32 + lane < n)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = f32(xv[j].v[i]);
        ss += v * v;
      }
  return ss;
}

template <typename Tx, int V>
__device__ __forceinline__ Vec<Tx, V> norm_chunk(const Vec<Tx, V>& xv,
                                                 const Vec<float, V>& wv,
                                                 float r) {
  Vec<Tx, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) o.v[i] = cvt<Tx>(f32(xv.v[i]) * r * wv.v[i]);
  return o;
}

// One warp a row, kFwdWarps warps a CTA, a CTA for every kFwdWarps rows:
// the rows' loads are all issued at once, as the block scheduler starts the
// CTAs, and the lane's slice of w is read (from the L2) next to its row. x is
// read and y written as streams (evict-first), which keeps w and rstd in the
// caches.
template <typename Tx, int V, int CPL>
__global__ void __launch_bounds__(kFwdWarps * 32)
rms_fwd_warp_kernel(const Fwd p) {
  using VT = Vec<Tx, V>;
  const int lane = threadIdx.x & 31, n = p.nchunks;
  const long long row =
      static_cast<long long>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  VT xv[CPL];
  Vec<float, V> w[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (j * 32 + lane < n)
      xv[j] = load_once<Tx, V>(p.x, row * n + j * 32 + lane);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (j * 32 + lane < n)
      w[j] = load_w<Tx, V>(p.w, p.w_code, p.cast_w, j * 32 + lane);
  const float ss = warp_sum(sum_sq<Tx, V, CPL>(xv, lane, n));
  const float r = rsqrtf(ss / p.d + p.eps);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (j * 32 + lane < n)
      store_once<Tx, V>(p.y, row * n + j * 32 + lane,
                        norm_chunk<Tx, V>(xv[j], w[j], r));
  if (lane == 0) p.rstd[row] = r;
}

// the CTA's sum of `v` (every thread's), in warp order; `red` holds two
// buffers of 32 so that one barrier a row suffices
__device__ __forceinline__ float cta_sum(float v, float (*red)[32],
                                         int parity) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[parity][threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int nw = blockDim.x >> 5;
  for (int i = 0; i < nw; ++i) s += red[parity][i];
  return s;
}

template <typename Tx, int V>
__global__ void __launch_bounds__(kCtaThreads)
rms_fwd_cta_kernel(const Fwd p) {
  __shared__ float red[2][32];
  const int t = threadIdx.x, nt = blockDim.x, n = p.nchunks;
  Vec<float, V> w[kCtaChunks];
  Vec<Tx, V> xv[kCtaChunks];
#pragma unroll
  for (int j = 0; j < kCtaChunks; ++j)
    if (j * nt + t < n)
      w[j] = load_w<Tx, V>(p.w, p.w_code, p.cast_w, j * nt + t);
  int parity = 0;
  for (long long row = blockIdx.x; row < p.rows;
       row += gridDim.x, parity ^= 1) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kCtaChunks; ++j)
      if (j * nt + t < n) xv[j] = load<Tx, V>(p.x, row * n + j * nt + t);
#pragma unroll
    for (int j = 0; j < kCtaChunks; ++j)
      if (j * nt + t < n)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = f32(xv[j].v[i]);
          ss += v * v;
        }
    for (int c = kCtaChunks * nt + t; c < n; c += nt) {
      const Vec<Tx, V> o = load<Tx, V>(p.x, row * n + c);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = f32(o.v[i]);
        ss += v * v;
      }
    }
    const float r = rsqrtf(cta_sum(ss, red, parity) / p.d + p.eps);
#pragma unroll
    for (int j = 0; j < kCtaChunks; ++j)
      if (j * nt + t < n)
        store<Tx, V>(p.y, row * n + j * nt + t,
                     norm_chunk<Tx, V>(xv[j], w[j], r));
    for (int c = kCtaChunks * nt + t; c < n; c += nt)
      store<Tx, V>(p.y, row * n + c,
                   norm_chunk<Tx, V>(load<Tx, V>(p.x, row * n + c),
                                     load_w<Tx, V>(p.w, p.w_code, p.cast_w,
                                                   c),
                                     r));
    if (t == 0) p.rstd[row] = r;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// sum over the chunk of w*dy * x^
template <typename Tx, typename Tdy, int V>
__device__ __forceinline__ float dot_chunk(const Vec<Tx, V>& xv,
                                           const Vec<Tdy, V>& gv,
                                           const Vec<float, V>& wv, float r) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
    s += f32(gv.v[i]) * wv.v[i] * (f32(xv.v[i]) * r);
  return s;
}

// dx of the chunk; adds dy * x^ to acc
template <typename Tx, typename Tdy, int V>
__device__ __forceinline__ Vec<Tdy, V> dx_chunk(const Vec<Tx, V>& xv,
                                                const Vec<Tdy, V>& gv,
                                                const Vec<float, V>& wv,
                                                float r, float c,
                                                float (&acc)[V]) {
  Vec<Tdy, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float xh = f32(xv.v[i]) * r;
    const float g = f32(gv.v[i]);
    o.v[i] = cvt<Tdy>((g * wv.v[i] - xh * c) * r);
    acc[i] += g * xh;
  }
  return o;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `p` (this CTA's shared memory) in cluster CTA `rank`'s
__device__ __forceinline__ uint32_t in_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(ft5::mma::smem_addr(p)), "r"(rank));
  return a;
}

// V floats into another CTA's shared memory (`dst`, 16-byte aligned where V
// is a multiple of 4), completing on its mbarrier `bar`
template <int V>
__device__ __forceinline__ void push(uint32_t dst, uint32_t bar,
                                     const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
          "[%0], {%1, %2, %3, %4}, [%5];\n"
          :: "r"(dst + 4 * i), "r"(__float_as_uint(v[i])),
             "r"(__float_as_uint(v[i + 1])), "r"(__float_as_uint(v[i + 2])),
             "r"(__float_as_uint(v[i + 3])), "r"(bar)
          : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
          "[%0], %1, [%2];\n"
          :: "r"(dst + 4 * i), "r"(__float_as_uint(v[i])), "r"(bar)
          : "memory");
  }
}

// one arrival on a ticket, ordered after what the CTA wrote before it (the
// caller's __syncthreads, then this release) and before what it reads after
__device__ __forceinline__ int take_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// out(col, sum over k < terms of load(k, col)) for each col < len, every sum
// in a fixed order: `groups` groups of threads each add a run of terms in
// order, then the groups' sums are added in group order. Every thread calls
// it; `scratch` holds blockDim.x floats.
template <typename Load, typename Out>
__device__ __forceinline__ void sum_columns(int len, int terms, Load load,
                                            Out out, float* scratch) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (len <= 0) return;
  const int groups = max(1, min(terms, nt / len));
  // terms [k0, k1) of column col, in order, their loads issued 16 at once
  auto run = [&](int k0, int k1, int col) {
    float s = 0.f;
    for (; k0 < k1; k0 += 16) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = k0 + i < k1 ? load(k0 + i, col) : 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) s += v[i];
    }
    return s;
  };
  if (groups == 1) {
    for (int col = t; col < len; col += nt) out(col, run(0, terms, col));
    return;
  }
  const int g = t / len, col = t % len;
  if (g < groups)
    scratch[g * len + col] =
        run(g * terms / groups, (g + 1) * terms / groups, col);
  __syncthreads();
  if (t < len) {
    float s = 0.f;
    for (int i = 0; i < groups; ++i) s += scratch[i * len + t];
    out(t, s);
  }
  __syncthreads();
}

// Where the cluster's sum of a column goes: dW itself for a grid of one
// cluster, else the cluster's partial row (after the grid's CTA partials).
template <typename Tx>
__device__ __forceinline__ void put_column(const Bwd& p, int C, int cid,
                                           int col, float s) {
  if (C == 1)
    p.dw[col] = p.cast_w ? f32(cvt<Tx>(s)) : s;
  else
    p.part[static_cast<long long>(gridDim.x + cid) * p.d + col] = s;
}

// dW's columns [lo, hi) from the C cluster partials, by the last CTA of this
// cluster rank to take its ticket, in cluster order. Every thread calls it.
template <typename Tx>
__device__ void merge_clusters(const Bwd& p, int rank, int C, int lo, int hi,
                               float* scratch) {
  __shared__ int last;
  if (C == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) last = take_ticket(p.tickets + rank) == C - 1;
  __syncthreads();
  if (!last) return;
  const float* cpart = p.part + static_cast<long long>(gridDim.x) * p.d + lo;
  sum_columns(
      hi - lo, C,
      [&](int k, int col) {
        return __ldcg(cpart + static_cast<long long>(k) * p.d + col);
      },
      [&](int col, float s) {
        p.dw[lo + col] = p.cast_w ? f32(cvt<Tx>(s)) : s;
      },
      scratch);
  if (threadIdx.x == 0) p.tickets[rank] = 0;
}

// One warp a row over a persistent grid: the warp strides over the rows
// with the next row's loads in flight while it computes the current one,
// its slice of w and its columns' dW sums in registers throughout. The
// sums then go to the CTAs of the cluster that own their columns.
template <typename Tx, typename Tdy, int V, int CPL>
__global__ void __launch_bounds__(kWarpRows * 32)
rms_bwd_warp_kernel(const Bwd p) {
  // (K, warps, sc * V): the dW sums of this CTA's slice of the columns
  // pushed by each warp of each CTA of the cluster, arriving on `inbox_bar`
  extern __shared__ __align__(16) float inbox[];
  __shared__ __align__(8) uint64_t inbox_bar;
  __shared__ float scratch[kWarpRows * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, n = p.nchunks;
  const long long stride = static_cast<long long>(gridDim.x) * nw;
  long long row = static_cast<long long>(blockIdx.x) * nw + warp;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int sc = (n + K - 1) / K;  // chunks a CTA's slice of the columns
  const int c0 = min(n, rank * sc), c1 = min(n, c0 + sc);
  if (threadIdx.x == 0) {
    ft5::mma::mbar_init(&inbox_bar, 1);
    ft5::mma::fence_mbar_init();
    ft5::mma::mbar_expect_tx(&inbox_bar, K * nw * (c1 - c0) * V * 4);
  }
  cluster_arrive();  // waited for before the first push into a peer
  Vec<float, V> w[CPL];
  Vec<Tx, V> xc[CPL], xn[CPL];
  Vec<Tdy, V> gc[CPL], gn[CPL];
  float acc[CPL][V];
  float rc = 0.f, rn = 0.f;
  if (row < p.rows) {
    rc = p.rstd[row];
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (j * 32 + lane < n) {
        xc[j] = load_once<Tx, V>(p.x, row * n + j * 32 + lane);
        gc[j] = load_once<Tdy, V>(p.dy, row * n + j * 32 + lane);
      }
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
    if (j * 32 + lane < n)
      w[j] = load_w<Tx, V>(p.w, p.w_code, p.cast_w, j * 32 + lane);
  }
  for (; row < p.rows; row += stride) {
    const long long next = row + stride;
    if (next < p.rows) {
      rn = p.rstd[next];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (j * 32 + lane < n) {
          xn[j] = load_once<Tx, V>(p.x, next * n + j * 32 + lane);
          gn[j] = load_once<Tdy, V>(p.dy, next * n + j * 32 + lane);
        }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (j * 32 + lane < n) s += dot_chunk<Tx, Tdy, V>(xc[j], gc[j], w[j], rc);
    const float c = warp_sum(s) / p.d;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      if (j * 32 + lane < n)
        store_once<Tdy, V>(p.dx, row * n + j * 32 + lane,
                           dx_chunk<Tx, Tdy, V>(xc[j], gc[j], w[j], rc, c,
                                                acc[j]));
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      xc[j] = xn[j];
      gc[j] = gn[j];
    }
    rc = rn;
  }
  // each chunk's sums to the CTA of the cluster that owns its slice
  cluster_wait();
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = j * 32 + lane;
    if (c < n) {
      const int owner = c / sc;
      push<V>(in_rank(inbox + ((rank * nw + warp) * sc + c - owner * sc) * V,
                      owner),
              in_rank(&inbox_bar, owner), acc[j]);
    }
  }
  ft5::mma::mbar_wait(&inbox_bar, 0);
  cluster_arrive_relaxed();  // every push into this CTA has landed
  // the slice's sums over the cluster's CTAs, then warps, in order
  const int C = gridDim.x / K, cid = blockIdx.x / K;
  sum_columns(
      (c1 - c0) * V, K * nw,
      [&](int k, int col) { return inbox[k * sc * V + col]; },
      [&](int col, float v) { put_column<Tx>(p, C, cid, c0 * V + col, v); },
      scratch);
  merge_clusters<Tx>(p, rank, C, c0 * V, c1 * V, scratch);
  cluster_wait();  // no CTA leaves while a peer may push into it
}

template <typename Tx, typename Tdy, int V>
__global__ void __launch_bounds__(kCtaThreads)
rms_bwd_cta_kernel(const Bwd p) {
  __shared__ float red[2][32];
  __shared__ float scratch[kCtaThreads];
  const int t = threadIdx.x, nt = blockDim.x, n = p.nchunks;
  float* part = p.part + static_cast<long long>(blockIdx.x) * p.d;
  Vec<float, V> w[kCtaChunks];
  Vec<Tx, V> xv[kCtaChunks];
  Vec<Tdy, V> gv[kCtaChunks];
  float acc[kCtaChunks][V];
#pragma unroll
  for (int j = 0; j < kCtaChunks; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
    if (j * nt + t < n)
      w[j] = load_w<Tx, V>(p.w, p.w_code, p.cast_w, j * nt + t);
  }
  // the thread's columns beyond what it holds sum in its CTA's partial row
  for (int c = kCtaChunks * nt + t; c < n; c += nt)
#pragma unroll
    for (int i = 0; i < V; ++i) part[c * V + i] = 0.f;
  int parity = 0;
  for (long long row = blockIdx.x; row < p.rows;
       row += gridDim.x, parity ^= 1) {
    const float r = p.rstd[row];
#pragma unroll
    for (int j = 0; j < kCtaChunks; ++j)
      if (j * nt + t < n) {
        xv[j] = load<Tx, V>(p.x, row * n + j * nt + t);
        gv[j] = load<Tdy, V>(p.dy, row * n + j * nt + t);
      }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kCtaChunks; ++j)
      if (j * nt + t < n) s += dot_chunk<Tx, Tdy, V>(xv[j], gv[j], w[j], r);
    for (int c = kCtaChunks * nt + t; c < n; c += nt)
      s += dot_chunk<Tx, Tdy, V>(load<Tx, V>(p.x, row * n + c),
                                 load<Tdy, V>(p.dy, row * n + c),
                                 load_w<Tx, V>(p.w, p.w_code, p.cast_w, c),
                                 r);
    const float c = cta_sum(s, red, parity) / p.d;
#pragma unroll
    for (int j = 0; j < kCtaChunks; ++j)
      if (j * nt + t < n)
        store<Tdy, V>(p.dx, row * n + j * nt + t,
                      dx_chunk<Tx, Tdy, V>(xv[j], gv[j], w[j], r, c, acc[j]));
    for (int k = kCtaChunks * nt + t; k < n; k += nt) {
      float a[V];
#pragma unroll
      for (int i = 0; i < V; ++i) a[i] = part[k * V + i];
      store<Tdy, V>(p.dx, row * n + k,
                    dx_chunk<Tx, Tdy, V>(load<Tx, V>(p.x, row * n + k),
                                         load<Tdy, V>(p.dy, row * n + k),
                                         load_w<Tx, V>(p.w, p.w_code,
                                                       p.cast_w, k),
                                         r,
                                         c, a));
#pragma unroll
      for (int i = 0; i < V; ++i) part[k * V + i] = a[i];
    }
  }
#pragma unroll
  for (int j = 0; j < kCtaChunks; ++j)
    if (j * nt + t < n)
#pragma unroll
      for (int i = 0; i < V; ++i) part[(j * nt + t) * V + i] = acc[j][i];
  // the cluster's partial rows, slice `rank` of them in rank order
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int C = gridDim.x / K, cid = blockIdx.x / K, sc = (n + K - 1) / K;
  const int c0 = min(n, rank * sc), c1 = min(n, c0 + sc);
  const float* first = part - static_cast<long long>(rank) * p.d + c0 * V;
  __threadfence();
  cluster.sync();
  sum_columns(
      (c1 - c0) * V, K,
      [&](int k, int col) {
        return __ldcg(first + static_cast<long long>(k) * p.d + col);
      },
      [&](int col, float v) { put_column<Tx>(p, C, cid, c0 * V + col, v); },
      scratch);
  merge_clusters<Tx>(p, rank, C, c0 * V, c1 * V, scratch);
}

// ---------------------------------------------------------------------------
// kernel choice and launch
// ---------------------------------------------------------------------------

template <typename Tx, int V>
const void* fwd_form(int cpl) {
  switch (cpl) {
    case 0: return reinterpret_cast<const void*>(rms_fwd_cta_kernel<Tx, V>);
    case 1: return reinterpret_cast<const void*>(rms_fwd_warp_kernel<Tx, V, 1>);
    case 2: return reinterpret_cast<const void*>(rms_fwd_warp_kernel<Tx, V, 2>);
    case 4: return reinterpret_cast<const void*>(rms_fwd_warp_kernel<Tx, V, 4>);
    default: return nullptr;
  }
}

template <typename Tx>
const void* fwd_kernel_t(int vec, int cpl) {
  return vec ? fwd_form<Tx, 16 / sizeof(Tx)>(cpl) : fwd_form<Tx, 1>(cpl);
}

const void* fwd_kernel(int x_dtype, int vec, int cpl) {
  switch (x_dtype) {
    case ft5::kFloat32: return fwd_kernel_t<float>(vec, cpl);
    case ft5::kBFloat16: return fwd_kernel_t<__nv_bfloat16>(vec, cpl);
    case kFloat16: return fwd_kernel_t<__half>(vec, cpl);
    default: return nullptr;
  }
}

template <typename Tx, typename Tdy, int V>
const void* bwd_form(int cpl) {
  switch (cpl) {
    case 0:
      return reinterpret_cast<const void*>(rms_bwd_cta_kernel<Tx, Tdy, V>);
    case 1:
      return reinterpret_cast<const void*>(rms_bwd_warp_kernel<Tx, Tdy, V, 1>);
    case 2:
      return reinterpret_cast<const void*>(rms_bwd_warp_kernel<Tx, Tdy, V, 2>);
    case 4:
      return reinterpret_cast<const void*>(rms_bwd_warp_kernel<Tx, Tdy, V, 4>);
    default: return nullptr;
  }
}

template <typename Tx, typename Tdy>
const void* bwd_kernel_tt(int vec, int cpl) {
  return vec ? bwd_form<Tx, Tdy, 16 / sizeof(Tx)>(cpl)
             : bwd_form<Tx, Tdy, 1>(cpl);
}

template <typename Tx>
const void* bwd_kernel_t(int dy_dtype, int vec, int cpl) {
  switch (dy_dtype) {
    case ft5::kFloat32: return bwd_kernel_tt<Tx, float>(vec, cpl);
    case ft5::kBFloat16: return bwd_kernel_tt<Tx, __nv_bfloat16>(vec, cpl);
    case kFloat16: return bwd_kernel_tt<Tx, __half>(vec, cpl);
    default: return nullptr;
  }
}

const void* bwd_kernel(int x_dtype, int dy_dtype, int vec, int cpl) {
  switch (x_dtype) {
    case ft5::kFloat32: return bwd_kernel_t<float>(dy_dtype, vec, cpl);
    case ft5::kBFloat16: return bwd_kernel_t<__nv_bfloat16>(dy_dtype, vec, cpl);
    case kFloat16: return bwd_kernel_t<__half>(dy_dtype, vec, cpl);
    default: return nullptr;
  }
}

int dtype_bytes(int code) { return code == ft5::kFloat32 ? 4 : 2; }

// How x (rows, d) is cut, from its shape and types alone: the warp form's
// chunks a lane (1, 2 or 4; 0 for the CTA form), a CTA's warps, a row's
// chunks of V elements, and the kernel (null for what no kernel takes).
// `y_dtype` is dy's for the backward (x's for the forward); `vec` 1 where
// rows are whole 16-byte vectors of x's type and every tensor is aligned to
// them.
struct Cut {
  int cpl = 0, warps = 0, n = 0, V = 0;
  const void* kernel = nullptr;
  Cut(int backward, long long rows, int d, int x_dtype, int y_dtype,
      int vec) {
    if (rows < 0 || d < 1 || x_dtype < 0 || x_dtype > kFloat16 ||
        y_dtype < 0 || y_dtype > kFloat16)
      return;
    V = vec ? (x_dtype == ft5::kFloat32 ? 4 : 8) : 1;
    if (d % V) return;
    n = d / V;
    cpl = n <= 32 ? 1 : n <= 64 ? 2 : n <= kWarpChunks ? 4 : 0;
    if (!cpl)
      warps = std::min(kCtaThreads / 32,
                       (n + 32 * kCtaChunks - 1) / (32 * kCtaChunks));
    else if (!backward)
      warps = kFwdWarps;
    else  // a few rows (decode): one warp a CTA, each CTA on its own SM
      warps = rows <= kWarpRows ? 1 : kWarpRows;
    kernel = backward ? bwd_kernel(x_dtype, y_dtype, vec, cpl)
                      : fwd_kernel(x_dtype, vec, cpl);
  }
  // the backward warp form's inbox: (K, warps, ceil(n / K) chunks of V)
  size_t inbox(int K) const {
    return cpl ? static_cast<size_t>(K) * warps * ((n + K - 1) / K) * V * 4
               : 0;
  }
};

// a launch's error, also cleared from the runtime's last error; else the
// last error, where a refused launch reports
cudaError_t launched(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// The launch plan for x (rows, d): out = {cpl, warps, grid, cluster}: the
// warp form's chunks a lane (1, 2 or 4; 0 for the CTA form), a CTA's warps,
// the CTAs (for the forward's warp form one for every kFwdWarps rows, else
// persistent: at most what the card holds at once) and the backward's CTAs
// a cluster (grid a multiple of it; 1 for the forward). `vec` 1 where rows
// are whole 16-byte vectors of x's type and every tensor is aligned to them.
// `y_dtype` is dy's for the backward (x's for the forward).
FT5_EXPORT int ft5_rms_norm_plan(int backward, long long rows, int d,
                                 int x_dtype, int y_dtype, int vec, int* out) {
  const Cut cut(backward, rows, d, x_dtype, y_dtype, vec);
  if (cut.kernel == nullptr) return cudaErrorInvalidValue;
  const long long rows_a_cta = cut.cpl ? cut.warps : 1;
  const long long want = std::max(1LL, (rows + rows_a_cta - 1) / rows_a_cta);
  out[0] = cut.cpl, out[1] = cut.warps, out[3] = 1;
  if (!backward && cut.cpl) {
    out[2] = static_cast<int>(std::min<long long>(want, INT_MAX));
    return cudaSuccess;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!backward) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cut.kernel,
                                                        cut.warps * 32, 0);
    if (err != cudaSuccess) return err;
    out[2] = static_cast<int>(
        std::min<long long>(want, std::max(1, sms * per_sm)));
    return cudaSuccess;
  }
  const int K = static_cast<int>(std::min<long long>(kMaxCluster, want));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(cut.warps * 32);
  cfg.dynamicSmemBytes = cut.inbox(K);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cut.kernel, &cfg);
  if (err != cudaSuccess) return err;
  const long long need = (want + K - 1) / K;
  out[2] = K * static_cast<int>(
                   std::min<long long>(need, std::max(1, clusters)));
  out[3] = K;
  return cudaSuccess;
}

// x (rows, d) and y in `x_dtype` (0 f32, 1 bf16, 2 f16), w (d,) in `w_dtype`,
// rstd (rows,) f32; contiguous; `grid` from ft5_rms_norm_plan. `cast_w`
// rounds w to x's type as it is loaded.
FT5_EXPORT int ft5_rms_norm_fwd(const void* x, const void* w, void* y,
                                float* rstd, long long rows, int d, float eps,
                                int x_dtype, int w_dtype, int cast_w, int vec,
                                int grid, void* stream) {
  const Cut cut(0, rows, d, x_dtype, x_dtype, vec);
  if (cut.kernel == nullptr || w_dtype < 0 || w_dtype > kFloat16 || grid < 1)
    return cudaErrorInvalidValue;
  Fwd p{x, w, y, rstd, rows, d, cut.n, w_dtype, cast_w, eps};
  void* args[] = {&p};
  return launched(cudaLaunchKernel(cut.kernel, dim3(grid),
                                   dim3(cut.warps * 32), args, 0,
                                   static_cast<cudaStream_t>(stream)));
}

// x (rows, d) in `x_dtype`, dy and dx in `dy_dtype`, w (d,) in `w_dtype`,
// rstd (rows,) and dw (d,) f32; part (grid + grid / cluster, d) f32 scratch;
// tickets (8,) int32, zero (and left at zero); `grid` and `cluster` from
// ft5_rms_norm_plan. `cast_w` rounds w to x's type as it is loaded and dW
// to x's type as it is written.
FT5_EXPORT int ft5_rms_norm_bwd(const void* x, const void* w,
                                const float* rstd, const void* dy, void* dx,
                                float* dw, float* part, int* tickets,
                                long long rows, int d, int x_dtype,
                                int w_dtype, int dy_dtype, int vec, int grid,
                                int cluster, int cast_w, void* stream) {
  const Cut cut(1, rows, d, x_dtype, dy_dtype, vec);
  if (cut.kernel == nullptr || w_dtype < 0 || w_dtype > kFloat16 ||
      cluster < 1 || cluster > kMaxCluster || grid < 1 || grid % cluster)
    return cudaErrorInvalidValue;
  Bwd p{x, w, rstd, dy, dx, dw, part, tickets, rows, d, cut.n, w_dtype,
        cast_w};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(cut.warps * 32);
  cfg.dynamicSmemBytes = cut.inbox(cluster);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&p};
  return launched(cudaLaunchKernelExC(&cfg, cut.kernel, args));
}
