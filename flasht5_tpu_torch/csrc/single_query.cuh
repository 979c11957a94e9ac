// Single-query (decode) attention over K/V rows read in runs, shared by
// decode_attention.cu (a (B, H, L, D) cache) and paged_decode_attention.cu
// (pages of a pool found through a page table).
//
// Both kernels are bound by bytes: one call reads each live position's K and
// V row once (plus an f32 scale each for int8) and does 4 * D operations a
// position. What holds such a kernel back on Hopper is too few loads in
// flight, so the design is about issuing every byte early:
//
// - The positions of a (slot, head) are cut into units, one per warp, and
//   the units over the warps of a CTA and the CTAs of a thread-block cluster
//   (unit u = cluster rank * warps + warp). The plan (splits, warps, unit) is
//   chosen from shapes alone by the Python wrapper, never from the lengths.
// - A unit is read in items: K or V values of up to `rows` positions of one
//   page (one contiguous run), with their f32 scales and, for K, the bias.
//   Each warp runs its own ring of kStages items: one lane issues an item
//   as 1-D bulk copies (cp.async.bulk) completing on the stage's mbarrier
//   (4-byte cp.async from every lane for a scale or bias run that is not
//   16-byte aligned), so a warp has up to kStages items in flight from its
//   first instructions; at the main path's shapes that is the warp's whole
//   share, K and V.
// - The page table (the paged kernel) is read once per warp, for the unit's
//   pages only, before any K/V copy is issued: no load waits on another.
// - Lanes own 16-byte slices of D (kTpr lanes a row), so a warp reads whole
//   rows of shared memory for q.k (a shuffle sum over the row's lanes) and
//   for P.V alike; int8 widens by a byte permute and one FADD.
// - Each warp keeps its softmax state (m, l) and accumulator in registers.
//   At the end the warps' states meet in shared memory (added in warp
//   order) and the CTAs' in rank 0's shared memory through distributed
//   shared memory (added in rank order): one launch, no workspace, no
//   atomics, the same bits on every run.
// - `exact`: every K item is scored first, the cluster agrees on the cache's
//   maximum through distributed shared memory, and only then is any P
//   formed and rounded (the decode kernel's caches of up to 512 positions,
//   where the TPU kernel rounds P against the whole cache's maximum).
//   Otherwise each warp runs an online softmax item by item.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace ft5 {
namespace sq {

namespace cg = cooperative_groups;

constexpr int kMaxWarps = 8;
constexpr int kMaxSplits = 8;      // a cluster's CTAs (the portable size)
constexpr int kStages = 4;         // items in flight a warp
constexpr int kItemBytes = 4096;   // value bytes of an item, at 16 rows or more

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// positions of one item for a row of `row_bytes`
__host__ __device__ constexpr int max_rows(int row_bytes) {
  return kItemBytes / row_bytes < 16 ? 16 : kItemBytes / row_bytes;
}

struct Params {
  const void *q, *k, *v;
  const float *ks, *vs;      // int8 scales, or null
  const int* table;          // (B, maxp) page ids, or null: page b of slot b
  const int* lengths;        // (B,), or null: every position
  const float* bias;         // (B, H, span), or null
  void* out;                 // (B, H, D)
  float *m_out, *l_out;      // (B, H), or null
  int H, D;
  int span;                  // positions a slot holds
  int page;                  // positions of a page
  int maxp;                  // table entries a slot
  long long page_stride, head_stride;      // value strides, elements
  long long s_page_stride, s_head_stride;  // scale strides, elements
  float sm_scale;
  int unit;                  // positions of a warp's share
  int rows;                  // positions of an item
  int sc_len;                // scores a warp holds
  int ids;                   // table entries a warp reads (0 without a table)
  int exact;                 // one maximum over the cache before any P
};

// Shared memory, in bytes from the start: per warp a ring of kStages items
// (values, then scales, then bias), the ring's mbarriers, its scores and its
// page ids; then the warps' states (m, l, acc[D]); then the cluster's inbox
// in rank 0 and the CTAs' maxima.
struct Smem {
  int vals, stage, warp, bars, sc, ids, state, inbox, maxima, total;
  __host__ __device__ Smem(const Params& p, int row_bytes, int warps,
                           int splits) {
    vals = align16(p.rows * row_bytes);
    stage = vals + 2 * align16(p.rows * 4);
    bars = kStages * stage;
    sc = bars + align16(kStages * 8);
    ids = sc + align16(p.sc_len * 4);
    warp = ids + align16(p.ids * 4);
    state = warps * warp;
    inbox = state + align16(warps * (p.D + 2) * 4);
    maxima = inbox + align16(splits * (p.D + 2) * 4);
    total = maxima + align16(kMaxSplits * 4);
  }
};

// `bytes` (a multiple of 16, both ends 16-byte aligned) in one bulk copy,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(mma::smem_addr(dst)), "l"(src), "r"(bytes),
         "r"(mma::smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ bool aligned16(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (bytes & 15) == 0;
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(mma::smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes of a row in shared memory as floats. int8 bytes go through
// XOR 0x80 and a byte permute into the mantissa of 2^23: one FADD then
// gives the integer exactly (no int-to-float conversion unit).
template <typename T>
__device__ __forceinline__ void widen16(const void* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] = __uint_as_float(__byte_perm(x, 0x4B000000u,
                                                     0x7540u | b)) -
                         8388736.0f;
    }
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  }
}

// The item sequence of a warp over its positions [t0, t1): an item is one
// plane (0 K, 1 V) of the positions [t, end), at most `rows` of page j
// (which ends at position `pend`). Exact: every K item, then every V item;
// otherwise K and V item by item.
struct Cursor {
  int plane, t, j, pend;
  __device__ __forceinline__ Cursor(const Params& p, int t0)
      : plane(0), t(t0), j(t0 / p.page), pend((t0 / p.page + 1) * p.page) {}
  __device__ __forceinline__ int end(const Params& p, int t1) const {
    return min(min(t1, t + p.rows), pend);
  }
  __device__ __forceinline__ void step(const Params& p, int t1) {
    t = end(p, t1);
    if (t == pend) ++j, pend += p.page;
  }
  __device__ __forceinline__ void next(const Params& p, int t0, int t1) {
    if (p.exact) {
      step(p, t1);
      if (plane == 0 && t >= t1) *this = Cursor(p, t0), plane = 1;
    } else if (plane == 0) {
      plane = 1;
    } else {
      plane = 0, step(p, t1);
    }
  }
  // (an exact sequence turns to its V items at t0 < t1, so t >= t1 only
  // at the end, or at once for an empty share)
  __device__ __forceinline__ bool done(int t1) const { return t >= t1; }
};

template <typename TQ, typename TKV, bool kBf16, int D>
__device__ __forceinline__ void attend(const Params& p, char* smem) {
  constexpr int kVec = 16 / sizeof(TKV);   // elements of a lane's slice
  constexpr int kTpr = D / kVec;           // lanes a row
  constexpr int kRpp = 32 / kTpr;          // rows a warp pass
  constexpr int kU = 4;                     // passes at a time
  static_assert(kTpr >= 1 && kTpr <= 32 && (kTpr & (kTpr - 1)) == 0,
                "row split");
  // values that enter the products rounded to bf16 (int8 and bf16 values
  // are bf16-exact already)
  constexpr bool kRoundV = kBf16 && std::is_same<TKV, float>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, grp = lane / kTpr, sub = lane % kTpr;
  const int bh = blockIdx.x / splits, b = bh / p.H, h = bh - b * p.H;
  const bool quant = p.ks != nullptr;
  // a CTA stores into a peer's shared memory only after every CTA of the
  // cluster has started: arrive now, wait before the first such store
  if (splits > 1) cluster_arrive_relaxed();

  const Smem lay(p, D * static_cast<int>(sizeof(TKV)), warps, splits);
  char* mine = smem + warp * lay.warp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(mine + lay.bars);
  float* sc = reinterpret_cast<float*>(mine + lay.sc);
  int* ids = reinterpret_cast<int*>(mine + lay.ids);
  float* state = reinterpret_cast<float*>(smem + lay.state);
  float* inbox = reinterpret_cast<float*>(smem + lay.inbox);
  float* maxima = reinterpret_cast<float*>(smem + lay.maxima);

  // the slot's length and the unit's table entries, loaded side by side
  const int t0 = (rank * warps + warp) * p.unit;
  const int pa = t0 / p.page;   // the unit's first page (paged: t0 on a page)
  const int raw_len = p.lengths != nullptr ? p.lengths[b] : p.span;
  if (p.table != nullptr) {
    for (int i = lane; i < p.ids && pa + i < p.maxp; i += 32)
      ids[i] = p.table[static_cast<size_t>(b) * p.maxp + pa + i];
    __syncwarp();
  }
  const int len = min(max(raw_len, 0), p.span);
  const int t1 = min(t0 + p.unit, len);

  // One item into stage `stage`: lane 0 copies the values run and each
  // 16-byte aligned scale or bias run in one bulk copy apiece, completing
  // on the stage's mbarrier; a run that is not aligned (a 66-position
  // cache's scales) goes by 4-byte copies of every lane, in the lanes'
  // commit group of the item.
  auto issue = [&](const Cursor& c, int stage) {
    char* st = mine + stage * lay.stage;
    const int off = c.t - c.j * p.page;
    const int n = c.end(p, t1) - c.t;
    const long long pid = p.table != nullptr ? ids[c.j - pa] : b;
    const long long row = pid * p.page_stride + h * p.head_stride +
                          static_cast<long long>(off) * D;
    const char* src = static_cast<const char*>(c.plane ? p.v : p.k) +
                      row * static_cast<long long>(sizeof(TKV));
    const int vbytes = n * D * static_cast<int>(sizeof(TKV));
    float* sst = reinterpret_cast<float*>(st + lay.vals);
    float* bst = sst + align16(p.rows * 4) / 4;
    const float* s = quant ? (c.plane ? p.vs : p.ks) + pid * p.s_page_stride +
                                 h * p.s_head_stride + off
                           : nullptr;
    const float* bsrc = c.plane == 0 && p.bias != nullptr
                            ? p.bias + static_cast<size_t>(bh) * p.span + c.t
                            : nullptr;
    const bool s_bulk = s != nullptr && aligned16(s, n * 4);
    const bool b_bulk = bsrc != nullptr && aligned16(bsrc, n * 4);
    if (lane == 0) {
      mma::fence_proxy_async();   // the stage's last reads came before
      mma::mbar_expect_tx(bars + stage,
                          vbytes + (s_bulk + b_bulk) * n * 4);
      bulk_copy(st, src, vbytes, bars + stage);
      if (s_bulk) bulk_copy(sst, s, n * 4, bars + stage);
      if (b_bulk) bulk_copy(bst, bsrc, n * 4, bars + stage);
    }
    if (s != nullptr && !s_bulk)
      for (int x = lane; x < n; x += 32) cp_async4(sst + x, s + x);
    if (bsrc != nullptr && !b_bulk)
      for (int x = lane; x < n; x += 32) cp_async4(bst + x, bsrc + x);
  };

  // fill the ring, one commit group an item (empty groups past the end),
  // so that item i's 4-byte copies are complete once at most kStages - 1
  // groups are pending; its bulk copies complete on its stage's mbarrier
  if (lane == 0) {
    for (int i = 0; i < kStages; ++i) mma::mbar_init(bars + i, 1);
    mma::fence_mbar_init();
  }
  __syncwarp();
  Cursor ic(p, t0), cc(p, t0);
  for (int s = 0; s < kStages; ++s) {
    if (!ic.done(t1)) {
      issue(ic, s);
      ic.next(p, t0, t1);
    }
    mma::cp_async_commit();
  }
  int consumed = 0;
  auto wait_item = [&]() -> const char* {
    const int stage = consumed % kStages;
    mma::cp_async_wait<kStages - 1>();
    mma::mbar_wait(bars + stage, (consumed / kStages) & 1);
    __syncwarp();
    return mine + stage * lay.stage;
  };
  auto release = [&]() {
    __syncwarp();   // every lane is done with the stage
    if (!ic.done(t1)) {
      issue(ic, consumed % kStages);
      ic.next(p, t0, t1);
    }
    mma::cp_async_commit();
    ++consumed;
    cc.next(p, t0, t1);
  };

  auto rnd = [](float x) { return kBf16 ? round_bf16(x) : x; };
  float qv[kVec];
  {
    const TQ* qr = static_cast<const TQ*>(p.q) + static_cast<size_t>(bh) * D +
                   sub * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) qv[e] = rnd(to_float(qr[e]));
  }

  // scores of the K item at `st` (n rows) into sc[base..], their maximum;
  // kU rows a lane at a time, their loads first, so that the products, the
  // shuffle sums and the shared memory reads of kU rows overlap
  auto score = [&](const char* st, int n, int base) {
    const float* ss = reinterpret_cast<const float*>(st + lay.vals);
    const float* bs = ss + align16(p.rows * 4) / 4;
    float cmax = kNegInf;
    auto finish_row = [&](int r, float dot) {
      if (quant) dot *= ss[r];
      dot *= p.sm_scale;
      if (p.bias != nullptr) dot += bs[r];
      sc[base + r] = dot;
      cmax = fmaxf(cmax, dot);
    };
    for (int r0 = 0; r0 < n; r0 += kU * kRpp) {
      float dot[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kRpp + grp;
        float x[kVec], d2[2] = {0.f, 0.f};
        if (r < n) {
          widen16<TKV>(st + (r * D + sub * kVec) * sizeof(TKV), x);
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            d2[e & 1] += qv[e] * (kRoundV ? round_bf16(x[e]) : x[e]);
        }
        dot[u] = d2[0] + d2[1];
      }
#pragma unroll
      for (int o = kTpr / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], o);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kRpp + grp;
        if (r < n && sub == 0) finish_row(r, dot[u]);
      }
    }
    return warp_max(cmax);
  };

  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
  // acc += P.V over the V item at `st`, P = sc[base..] (v scales folded
  // in), kU rows a lane at a time
  auto accumulate = [&](const char* st, int n, int base) {
    const float* ss = reinterpret_cast<const float*>(st + lay.vals);
    for (int r0 = 0; r0 < n; r0 += kU * kRpp) {
      float pr[kU], x[kU][kVec];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u * kRpp + grp;
        pr[u] = 0.f;
        if (r < n) {
          pr[u] = sc[base + r];
          if (quant) pr[u] *= ss[r];
          pr[u] = rnd(pr[u]);
          widen16<TKV>(st + (r * D + sub * kVec) * sizeof(TKV), x[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) x[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[e] += pr[u] * (kRoundV ? round_bf16(x[u][e]) : x[u][e]);
    }
  };

  float m = kNegInf, l = 0.f;   // l: this lane's share of the sum
  bool waited = false;   // the cluster's start barrier
  if (p.exact) {
    float wmax = kNegInf;
    while (cc.plane == 0 && !cc.done(t1)) {
      const char* st = wait_item();
      const int t = cc.t;
      wmax = fmaxf(wmax, score(st, cc.end(p, t1) - t, t - t0));
      release();
    }
    // the cache's maximum: the CTA's warps, then the cluster's CTAs
    if (lane == 0) state[warp] = wmax;
    __syncthreads();
    float cmax = kNegInf;
    for (int w = 0; w < warps; ++w) cmax = fmaxf(cmax, state[w]);
    if (splits > 1) {
      cluster_wait();
      waited = true;
      if (threadIdx.x < splits)
        *cluster.map_shared_rank(maxima + rank, threadIdx.x) = cmax;
      cluster.sync();
      for (int r = 0; r < splits; ++r) cmax = fmaxf(cmax, maxima[r]);
    } else {
      __syncthreads();   // state[] is rewritten below
    }
    for (int r = lane; r < t1 - t0; r += 32) {
      const float e = expf(sc[r] - cmax);
      sc[r] = e;
      l += e;
    }
    __syncwarp();
    if (t1 > t0) m = cmax;
    while (!cc.done(t1)) {
      const char* st = wait_item();
      const int t = cc.t;
      accumulate(st, cc.end(p, t1) - t, t - t0);
      release();
    }
  } else {
    float alpha = 1.f;
    while (!cc.done(t1)) {
      const char* st = wait_item();
      const int n = cc.end(p, t1) - cc.t;
      if (cc.plane == 0) {
        const float m_new = fmaxf(m, score(st, n, 0));
        alpha = expf(m - m_new);
        __syncwarp();
        l *= alpha;
        for (int r = lane; r < n; r += 32) {
          const float e = expf(sc[r] - m_new);
          sc[r] = e;
          l += e;
        }
        m = m_new;
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] *= alpha;
        accumulate(st, n, 0);
      }
      release();
    }
  }
  mma::cp_async_wait<0>();

  // the warp's row groups summed: each exchange hands half of a lane's
  // columns to its partner and adds the other half (a fixed pattern), so
  // each lane ends with D / 32 columns; then the warps' states in shared
  // memory: m, l, acc[D] a warp
  l = warp_sum(l);
  float* ws = state + warp * (D + 2);
  constexpr int kRounds = __builtin_ctz(kRpp);
  int col = sub * kVec;
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    const int o = kTpr << round, half = (kVec >> round) / 2;
    const bool upper = lane & o;
#pragma unroll
    for (int e = 0; e < half; ++e) {
      const float send = upper ? acc[e] : acc[e + half];
      const float keep = upper ? acc[e + half] : acc[e];
      acc[e] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (upper) col += half;
  }
#pragma unroll
  for (int e = 0; e < D / 32; ++e) ws[2 + col + e] = acc[e];
  if (lane == 0) ws[0] = m, ws[1] = l;
  __syncthreads();

  // the CTA's state: its warps' added in warp order against their maximum
  float f[kMaxWarps];
  float cm = kNegInf, cl = 0.f;
  for (int w = 0; w < warps; ++w) cm = fmaxf(cm, state[w * (D + 2)]);
#pragma unroll
  for (int w = 0; w < kMaxWarps; ++w)
    if (w < warps) {
      f[w] = expf(state[w * (D + 2)] - cm);
      cl += state[w * (D + 2) + 1] * f[w];
    }
  auto cta_acc = [&](int d) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w)
      if (w < warps) a += state[w * (D + 2) + 2 + d] * f[w];
    return a;
  };
  auto finish = [&](float mm, float ll, auto&& column) {
    const float l_safe = ll > 0.f ? ll : 1.f;
    TQ* o = static_cast<TQ*>(p.out) + static_cast<size_t>(bh) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      o[d] = from_float<TQ>(column(d) / l_safe);
    if (threadIdx.x == 0 && p.m_out != nullptr) {
      p.m_out[bh] = ll > 0.f ? mm : kNegInf;
      p.l_out[bh] = ll;
    }
  };
  if (splits == 1) {
    finish(cm, cl, cta_acc);
    return;
  }

  // the cluster's CTAs into rank 0's inbox, added there in rank order
  if (!waited) cluster_wait();
  float* slot = cluster.map_shared_rank(inbox, 0) + rank * (D + 2);
  for (int d = threadIdx.x; d < D; d += blockDim.x) slot[2 + d] = cta_acc(d);
  if (threadIdx.x == 0) slot[0] = cm, slot[1] = cl;
  cluster.sync();
  if (rank != 0) return;
  float wr[kMaxSplits];
  float mm = kNegInf, ll = 0.f;
  for (int r = 0; r < splits; ++r) mm = fmaxf(mm, inbox[r * (D + 2)]);
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    if (r < splits) {
      wr[r] = expf(inbox[r * (D + 2)] - mm);
      ll += inbox[r * (D + 2) + 1] * wr[r];
    }
  finish(mm, ll, [&](int d) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) a += inbox[r * (D + 2) + 2 + d] * wr[r];
    return a;
  });
}

// Launch `kernel` on B * H * splits CTAs in clusters of `splits`, `warps`
// warps each; sets the kernel's dynamic shared memory limit once a device.
template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned& devices_set, const Params& p,
                   int row_bytes, int B, int splits, int warps,
                   cudaStream_t stream) {
  if (splits < 1 || splits > kMaxSplits || warps < 1 || warps > kMaxWarps ||
      p.unit <= 0 || p.rows <= 0)
    return cudaErrorInvalidValue;
  const Smem lay(p, row_bytes, warps, splits);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(devices_set & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return err;
    devices_set |= 1u << dev;
  }
  if (lay.total > 232448) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * p.H * splits);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace sq
}  // namespace ft5
