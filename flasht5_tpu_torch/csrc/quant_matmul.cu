// Weight-only dequant matmul: out = x @ (W * scales), W int8 or fp8-e4m3.
//
// Replaces the Pallas kernel flasht5_tpu/ops/quant.py::_qmm_kernel (launched
// by quant_matmul). As there, x is rounded to bf16 (also when it is f32),
// the weight tile is dequantized to bf16 (exact for int8 and e4m3), the
// products accumulate in fp32, and the scales apply to the accumulator: once
// at the end for per-channel scales, once per scale group for group-wise
// scales. The output is in x's dtype.
//
// Bound on the H100: at decode (M = 8) the weight bytes bound it (an int8
// 512x2048 weight is 1 MB, read once); at prefill (M = 4096) the bf16
// tensor-core rate does (2 M K N operations: 8.6 GFLOP, 0.0087 ms at 989
// TFLOP/s, for both FAT5-small prefill shapes). Three forms, chosen by the
// shapes of the call:
//
// - qmm_wgmma_kernel, the prefill form (M > 32, bf16 x, N % 16 == 0, x
//   and W 16-byte aligned: every prefill projection of the serving and
//   scoring paths). A CTA owns a 128 x 128 output tile; K runs in steps of
//   64 through a ring of 6 stages in shared memory. Thread 0 keeps 4 steps
//   of TMA loads in flight, each completing on its stage's mbarrier: the x
//   tile (128 x 64 bf16, 128-byte swizzle, the layout wgmma reads) and the
//   raw W tile (64 x 128 bytes: int8 or e4m3 stays 1 byte an element in
//   flight, the saving the format exists for). When a stage lands, the two
//   warpgroups convert its W tile to bf16 in shared memory, transposed to
//   the same swizzled K-major layout, then each warpgroup runs 4
//   wgmma.m64n128k16 on its 64 rows. The products of step i run while
//   step i + 1 converts (one wgmma group kept in flight) and steps up to
//   i + 4 load. int8 is widened by full-rate byte permutes and FADDs, not
//   by the conversion units (int -> f32 -> bf16 at a quarter of the FP32
//   rate took half of this kernel's time on the H100; see convert_w).
//   Per-channel scales multiply the accumulator once at the
//   end; group scales (any multiple of 32, smaller or larger than a step)
//   fold a second accumulator into the first at each group's end, which
//   waits for the products in flight (ptxas serializes that form's wgmma
//   chain). TMA fills rows past M, columns past N and K past its end with
//   zeros. The epilogue stages the scaled bf16 tile in shared memory and
//   writes whole rows with 16-byte stores (the accumulator layout's 4-byte
//   stores to 8 rows at a time took a third of the time at N = 2048 on the
//   H100). A persistent form (a CTA per SM walking the tiles in one ring)
//   measured no faster there.
// - qmm_kernel, the mma.sync form for what TMA cannot describe (f32 x, N
//   not a multiple of 16, unaligned pointers) at M > 32: 64x64 output tiles
//   per CTA, four warps of 32x32, K in steps of 32 staged through shared
//   memory as bf16 by scalar loads, mma.sync.m16n8k16 bf16 -> fp32.
// - qmm_decode_kernel, the decode form for M <= 32 (N % 16 == 0, x and W
//   16-byte aligned; the plan is ops/quant.py::decode_plan's). At decode
//   the weight's bytes bound it: 256 KB to 16 MB read once, 0.08-5.2 us at
//   3.35 TB/s, so the card must be full of loads. K is split over a
//   cluster of up to 8 CTAs and, inside each CTA, over up to 8 warps: a
//   512-wide projection runs on 4 clusters of 8 CTAs, the lm_head on 256
//   CTAs of 8 warps and no cluster split (a CTA owns 128 columns). Each
//   thread streams W in 16-byte loads (16 int8 or e4m3 columns; 8 in
//   flight, read-only, not kept in L1) and keeps x in registers; the
//   product runs
//   on the tensor cores as out^T = W^T x^T (mma.sync m16n8k16: 16 output
//   columns by the CTA's 8 rows of x, so M = 8 wastes none of the mma),
//   with int8 widened by byte permutes and an FADD, as convert_w does. The
//   K pieces' f32 partial tiles are added in a fixed order, the warps' in
//   shared memory, then the cluster's CTAs' through distributed shared
//   memory, each CTA reducing one slice of the columns: one launch, no
//   workspace, no atomics, the same bits on every run. Group scales fold
//   in at each group's end and at a piece's end (a piece's boundary may
//   fall inside a group); per-channel scales apply once, in the reducing
//   CTA. M > 8 takes one CTA row per 8 rows of x.
// - qmm_kernel also takes M <= 32 where the decode form's loads do not fit
//   (N not a multiple of 16, unaligned pointers).
//
// Ragged M and N are masked; K must be a multiple of 32 (and of the group
// size), which the wrapper checks.

#include "common.cuh"
#include "mma.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row

__device__ __forceinline__ float weight_to_float(int8_t w) {
  return static_cast<float>(w);
}
__device__ __forceinline__ float weight_to_float(__nv_fp8_e4m3 w) {
  return static_cast<float>(w);
}

using ft5::mma::mma_bf16_16816;

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
           const float* __restrict__ scales, TX* __restrict__ out, int M,
           int N, int K, int group_size) {
  __shared__ __align__(16) __nv_bfloat16 as[kBM][kBK + kPad];  // x tile
  __shared__ __align__(16) __nv_bfloat16 bs[kBN][kBK + kPad];  // W^T tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float part[2][4][4];   // products of the current scale group
  float acc[2][4][4];    // scaled sum over finished groups
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, kc = idx - r * kBK;
      const int m = m0 + r;
      const float xv =
          m < M ? ft5::to_float(x[static_cast<size_t>(m) * K + k0 + kc]) : 0.f;
      as[r][kc] = __float2bfloat16_rn(xv);
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kr = idx / kBN, nc = idx - kr * kBN;
      const int n = n0 + nc;
      const float wv =
          n < N ? weight_to_float(w[static_cast<size_t>(k0 + kr) * N + n])
                : 0.f;
      bs[nc][kr] = __float2bfloat16_rn(wv);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r0 = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&as[r0][kk + tq * 2]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&as[r0 + 8][kk + tq * 2]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&as[r0][kk + tq * 2 + 8]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&as[r0 + 8][kk + tq * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&bs[c0][kk + tq * 2]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&bs[c0][kk + tq * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(part[i][j], a[i], b[j]);
    }
    __syncthreads();

    if ((k0 + kBK) % group_size == 0) {   // a scale group ends here
      const float* srow = scales + static_cast<size_t>(k0 / group_size) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + tq * 2;
        const float s0 = n < N ? srow[n] : 0.f;
        const float s1 = n + 1 < N ? srow[n + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][j][0] += part[i][j][0] * s0;
          acc[i][j][1] += part[i][j][1] * s1;
          acc[i][j][2] += part[i][j][2] * s0;
          acc[i][j][3] += part[i][j][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + wn + j * 8 + tq * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + i * 16 + g + half * 8;
        if (m >= M) continue;
        TX* orow = out + static_cast<size_t>(m) * N;
        if (n < N) orow[n] = ft5::from_float<TX>(acc[i][j][2 * half]);
        if (n + 1 < N) orow[n + 1] = ft5::from_float<TX>(acc[i][j][2 * half + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// Prefill form: TMA ring + wgmma
// ---------------------------------------------------------------------------

namespace wg {

using ft5::mma::bf16;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 6;          // the ring of x and raw W tiles
constexpr int kAhead = kStages - 2; // steps of TMA loads in flight
constexpr int kConv = 3;            // bf16 W tiles (see the loop's note)
constexpr int kThreads = 256;       // two warpgroups of 64 output rows
constexpr int kXBytes = kBM * kBK * 2;   // 16 KB
constexpr int kWBytes = kBK * kBN;       // 8 KB
constexpr int kBBytes = kBN * kBK * 2;   // 16 KB
constexpr int kSmem = kStages * (kXBytes + kWBytes) + kConv * kBBytes +
                      kStages * 8 + 1024;  // + the 1024-byte alignment

// an e4m3 byte's value
__device__ __forceinline__ float e4m3_to_float(uint32_t byte) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(v);
}

// The raw (64 k x 128 n) W tile into the bf16 (128 n x 64 k) tile in the
// 128-byte swizzled K-major layout: thread t reads columns 4 (t % 32)..+3
// of rows 8 (t / 32)..+7 (a warp reads 32 consecutive words of a row) and
// writes those 4 columns' 16-byte chunks of 8 k, in a rotated order: the 8
// threads of each 16-byte store phase write rows of 8 distinct n % 8, so 8
// distinct swizzled chunks, and no bank conflict either way.
//
// int8 runs on full-rate integer and FP32 units, not the conversion units
// (a quarter of the rate; through them the conversion took half of this
// kernel's time on the H100):
// a byte permute places byte ^ 0x80 (x + 128) in the mantissa of 2^23, one
// FADD subtracts 2^23 + 128, leaving x exactly, and since x has at most 8
// significant bits the f32's high half is its bf16, exactly. e4m3 goes
// through the hardware conversion.
template <typename TW>
__device__ __forceinline__ void convert_w(const uint8_t* raw, uint8_t* dst) {
  const int t = threadIdx.x;
  const int ng = t & 31, kg = t >> 5;
  const int rot = (ng >> 1) & 3;
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = *reinterpret_cast<const uint32_t*>(raw + (8 * kg + i) * kBN +
                                              4 * ng);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = s ^ rot, n = 4 * ng + j;
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
    if constexpr (std::is_same<TW, int8_t>::value) {
      const uint32_t sel = 0x7540u | static_cast<uint32_t>(j);
      float f[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[i] = __uint_as_float(__byte_perm(w[i] ^ 0x80808080u, 0x4B000000u,
                                           sel)) - 8388736.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = __byte_perm(__float_as_uint(f[2 * i]),
                           __float_as_uint(f[2 * i + 1]), 0x7632u);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] = ft5::mma::pack_bf16(
            e4m3_to_float((w[2 * i] >> (8 * j)) & 0xffu),
            e4m3_to_float((w[2 * i + 1] >> (8 * j)) & 0xffu));
    }
    *reinterpret_cast<uint4*>(dst + n * 128 + ((kg ^ (n & 7)) * 16)) = out;
  }
}

// the first array when B, else the second (an accumulator chosen at
// compile time, so it stays in registers)
template <bool B>
struct Pick {
  template <typename T, typename U>
  static __device__ __forceinline__ T& get(T& a, U&) { return a; }
};
template <>
struct Pick<false> {
  template <typename T, typename U>
  static __device__ __forceinline__ U& get(T&, U& b) { return b; }
};

using ft5::mma::fence_all;

// acc += part * the scales of group `grp`, column by column; part = 0
__device__ __forceinline__ void fold(float (&acc)[64], float (&part)[64],
                                     const float* __restrict__ scales,
                                     int grp, int n0, int N) {
  const int tq = threadIdx.x & 3;
  const float* srow = scales + static_cast<size_t>(grp) * N;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + 8 * j + 2 * tq + e;
      const float sc = n < N ? srow[n] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h + e] += part[4 * j + 2 * h + e] * sc;
        part[4 * j + 2 * h + e] = 0.f;
      }
    }
}

// kGroups: group-wise scales (group_size < K); else per-channel
template <typename TW, bool kGroups>
__global__ void __launch_bounds__(kThreads, 1)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmw,
                 const float* __restrict__ scales, bf16* __restrict__ out,
                 int M, int N, int K, int group_size) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = base;                              // kStages x tiles
  uint8_t* wr = xs + kStages * kXBytes;            // kStages raw W tiles
  uint8_t* bc = wr + kStages * kWBytes;            // kConv bf16 W tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(bc + kConv * kBBytes);

  const int tid = threadIdx.x, wgi = tid >> 7;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  auto load_step = [&](int i) {   // thread 0: step i's loads, its stage
    const int st = i % kStages;
    ft5::mma::mbar_expect_tx(&full[st], kXBytes + kWBytes);
    ft5::mma::tma_load_2d(xs + st * kXBytes, &tmx, &full[st], i * kBK, m0);
    ft5::mma::tma_load_2d(wr + st * kWBytes, &tmw, &full[st], n0, i * kBK);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) ft5::mma::mbar_init(&full[st], 1);
    ft5::mma::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kAhead && i < nk; ++i) load_step(i);
  __syncwarp();

  // per-channel scales: the products go straight into acc; group scales:
  // into part, folded into acc at each group's end
  float acc[64], part[kGroups ? 64 : 1];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < (kGroups ? 64 : 1); ++r) part[r] = 0.f;
  float (&sum)[64] = Pick<kGroups>::get(part, acc);

  // Step i: wait for its stage; convert its W tile into bf16 tile i % 3
  // (last read by step i - 3's products, finished: every thread passed
  // step i - 1's barrier after waiting for step i - 2's products); the
  // barrier over both warpgroups makes the tile whole and certifies that
  // step i - 2's products are done in both, so thread 0 refills that
  // stage with step i + kAhead; then the products, with one group left in
  // flight.
  for (int i = 0; i < nk; ++i) {
    const int st = i % kStages;
    uint8_t* bt = bc + (i % kConv) * kBBytes;
    ft5::mma::mbar_wait(&full[st], (i / kStages) & 1);
    convert_w<TW>(wr + st * kWBytes, bt);
    ft5::mma::fence_proxy_async();
    ft5::mma::named_sync(1, kThreads);
    if (tid == 0 && i + kAhead < nk) load_step(i + kAhead);
    __syncwarp();

    const uint64_t da = ft5::mma::wgmma_desc_sw128(xs + st * kXBytes +
                                                   wgi * (kXBytes / 2));
    const uint64_t db = ft5::mma::wgmma_desc_sw128(bt);
    fence_all(sum);
    ft5::mma::wgmma_fence();
    // past K (K % 64 == 32: the last step's second half) the tiles hold
    // TMA's zeros, which add nothing; no branch splits the wgmma chain
    bool pending = false;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int k_end = i * kBK + (kk + 1) * 16;
      ft5::mma::wgmma_m64n128k16(sum, da + 2 * kk, db + 2 * kk);
      pending = true;
      if constexpr (kGroups) {
        if (k_end <= K && k_end % group_size == 0) {   // a group ends
          ft5::mma::wgmma_commit();
          ft5::mma::wgmma_wait<0>();
          fence_all(part);
          fold(acc, part, scales, k_end / group_size - 1, n0, N);
          fence_all(part);
          ft5::mma::wgmma_fence();
          pending = false;
        }
      }
    }
    if (pending) {
      ft5::mma::wgmma_commit();
      ft5::mma::wgmma_wait<1>();
    }
  }
  ft5::mma::wgmma_wait<0>();
  fence_all(acc);

  // the epilogue: the scaled tile in bf16 into shared memory (rows of
  // kBN + 8 elements: the 8 rows of a store phase hit distinct banks), then
  // 16-byte coalesced stores of whole rows (N % 16 == 0: a 16-byte chunk is
  // all in or all out)
  constexpr int kOutLd = kBN + 8;
  bf16* ot = reinterpret_cast<bf16*>(xs);
  __syncthreads();                    // every stage's last reader is done
  const int w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + 2 * tq;
    float s0 = 1.f, s1 = 1.f;
    if (!kGroups && n < N) s0 = scales[n], s1 = scales[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wgi + 16 * w + g + 8 * h;
      *reinterpret_cast<uint32_t*>(ot + r * kOutLd + 8 * j + 2 * tq) =
          ft5::mma::pack_bf16(acc[4 * j + 2 * h] * s0,
                              acc[4 * j + 2 * h + 1] * s1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kBM * kBN / 8 / kThreads; ++e) {
    const int idx = tid + e * kThreads;
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) =
          *reinterpret_cast<const uint4*>(ot + r * kOutLd + c);
  }
}

using ft5::mma::make_map;

template <typename TW>
cudaError_t launch(const void* x, const void* w, const float* scales,
                   void* out, int M, int N, int K, int group_size,
                   cudaStream_t stream) {
  CUtensorMap tmx, tmw;
  if (!make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2, kBM, kBK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, 1, kBK, kBN,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, kSmem, stream>>>(
        tmx, tmw, scales, static_cast<bf16*>(out), M, N, K, group_size);
    return cudaGetLastError();
  };
  if (group_size < K) return run(qmm_wgmma_kernel<TW, true>);
  return run(qmm_wgmma_kernel<TW, false>);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Decode form: K split over a thread-block cluster, mma.sync on W^T x^T
// ---------------------------------------------------------------------------

namespace dec {

namespace cg = cooperative_groups;

constexpr int kMaxM = 32;        // largest M that takes the decode form
constexpr int kRows = 8;         // x rows per CTA: the mma's n
constexpr int kCols = 128;       // output columns per CTA: 16 a quad
constexpr int kLd = kCols + 4;   // row stride (floats) of a warp's tile
constexpr int kMaxWarps = 8;     // a CTA's K pieces, one per warp
constexpr int kMaxSplits = 8;    // a cluster's CTAs (the portable size)

// 16 bytes of W, read-only and not kept in L1 (each byte is read once)
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// byte b of the rows' words w0 and w1 (one column, two K rows) as a bf16
// pair, w0's in the low half. int8 words come XOR 0x80808080 (see
// wg::convert_w: a byte permute into the mantissa of 2^23 and one FADD
// give the integer exactly, and its f32's high half is its bf16).
template <typename TW>
__device__ __forceinline__ uint32_t wpair(uint32_t w0, uint32_t w1, int b) {
  if constexpr (std::is_same<TW, int8_t>::value) {
    const uint32_t sel = 0x7540u | static_cast<uint32_t>(b);
    const float f0 =
        __uint_as_float(__byte_perm(w0, 0x4B000000u, sel)) - 8388736.0f;
    const float f1 =
        __uint_as_float(__byte_perm(w1, 0x4B000000u, sel)) - 8388736.0f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
  } else {
    return ft5::mma::pack_bf16(wg::e4m3_to_float((w0 >> (8 * b)) & 0xffu),
                               wg::e4m3_to_float((w1 >> (8 * b)) & 0xffu));
  }
}

// x[m][k..k+3] rounded to bf16: the mma's B fragment (K rows k, k+1 | k+2,
// k+3 at column m)
__device__ __forceinline__ uint2 x_frag(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint2 x_frag(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return make_uint2(ft5::mma::pack_bf16(v.x, v.y),
                    ft5::mma::pack_bf16(v.z, v.w));
}

// acc += part * the scales of group `grp` at this quad's 16 columns from
// nq; part = 0. Fragment f's c[0..1] are column nq + 2f, c[2..3] nq + 2f + 1.
__device__ __forceinline__ void fold(float (&acc)[8][4], float (&part)[8][4],
                                     const float* __restrict__ scales,
                                     int grp, int nq, int N, bool n_ok) {
  const float* srow = scales + static_cast<size_t>(grp) * N + nq;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    const float s0 = n_ok ? srow[2 * f] : 0.f;
    const float s1 = n_ok ? srow[2 * f + 1] : 0.f;
    acc[f][0] += part[f][0] * s0;
    acc[f][1] += part[f][1] * s0;
    acc[f][2] += part[f][2] * s1;
    acc[f][3] += part[f][3] * s1;
#pragma unroll
    for (int e = 0; e < 4; ++e) part[f][e] = 0.f;
  }
}

// out (M x N) = x (M x K) @ (W * scales) for M <= 32. The product runs as
// out^T = W^T x^T on mma.sync m16n8k16: W^T is the A operand (16 output
// columns x 16 K rows), x^T the B operand (16 K rows x the CTA's 8 rows of
// x). Thread (g, tq) of a warp loads 16 bytes from each of 4 K rows
// (k + 4 tq .. + 3) at 16 columns nq = n0 + 16 g: the k order inside a
// fragment is free as long as A and B agree, so K slots 2tq, 2tq + 1,
// 2tq + 8, 2tq + 9 are rows k + 4tq + 0..3, and x's B fragment is one
// 8-byte load of x[m][k + 4tq .. + 3]; fragment f takes columns nq + 2f
// and nq + 2f + 1 as A rows g and g + 8. Warp `warp` of CTA `rank` of the
// cluster sums K piece rank * warps + warp (k_piece rows, a multiple of
// 16; group scales fold in at each group's end and at the piece's end).
// The warps' partial tiles meet in shared memory and are added in warp
// order; each CTA stores its tile's column slices into the inboxes of the
// CTAs that reduce them (slice `rank` of the 128 columns belongs to
// cluster rank `rank`; distributed shared memory), one cluster barrier,
// then each CTA adds its inbox's tiles in rank order, applies per-channel
// scales and writes the output. No atomics: the same bits on every run.
template <typename TX, typename TW, bool kGroups>
__global__ void __launch_bounds__(kMaxWarps * 32)
qmm_decode_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ scales, TX* __restrict__ out,
                  int M, int N, int K, int group_size, int k_piece) {
  // the warps' partial tiles [warps][kRows][kLd], then the inbox of the
  // cluster's CTA tiles of this CTA's columns [splits][kRows][slice + 4]
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int warps = blockDim.x >> 5;
  float* inbox = red + warps * kRows * kLd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = (blockIdx.x / splits) * kCols, m0 = blockIdx.y * kRows;
  const int nq = n0 + 16 * g;          // N % 16 == 0: all 16 in or all out
  const bool n_ok = nq < N;
  const int k_begin = min(K, (rank * warps + warp) * k_piece);
  const int k_end = min(K, k_begin + k_piece);
  const bool m_ok = m0 + g < M;
  const TX* xrow = x + static_cast<size_t>(m_ok ? m0 + g : 0) * K;
  // every CTA of the cluster must have started before another stores into
  // its shared memory: arrive now, wait before the stores
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  float acc[8][4], part[kGroups ? 8 : 1][4];
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
#pragma unroll
  for (int f = 0; f < (kGroups ? 8 : 1); ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[f][e] = 0.f;
  auto& sum = wg::Pick<kGroups>::get(part, acc);

  // two steps of 16 K rows a batch: 8 loads of 16 bytes in flight a thread
  for (int k = k_begin; k < k_end; k += 32) {
    uint4 ld[2][4];
    uint2 xb[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kr = k + 16 * u + 4 * tq;
      const bool in = k + 16 * u < k_end;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ld[u][j] = in && n_ok
            ? ldg_stream(w + static_cast<size_t>(kr + j) * N + nq)
            : make_uint4(0u, 0u, 0u, 0u);
      xb[u] = in && m_ok ? x_frag(xrow + kr) : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (k + 16 * u >= k_end) break;
      uint32_t lw[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lw[j][0] = ld[u][j].x, lw[j][1] = ld[u][j].y;
        lw[j][2] = ld[u][j].z, lw[j][3] = ld[u][j].w;
        if constexpr (std::is_same<TW, int8_t>::value) {
#pragma unroll
          for (int q = 0; q < 4; ++q) lw[j][q] ^= 0x80808080u;
        }
      }
      const uint32_t b[2] = {xb[u].x, xb[u].y};
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const int q = f >> 1, bb = 2 * (f & 1);
        uint32_t a[4];
        a[0] = wpair<TW>(lw[0][q], lw[1][q], bb);       // column 2f
        a[1] = wpair<TW>(lw[0][q], lw[1][q], bb + 1);   // column 2f + 1
        a[2] = wpair<TW>(lw[2][q], lw[3][q], bb);
        a[3] = wpair<TW>(lw[2][q], lw[3][q], bb + 1);
        ft5::mma::mma_bf16_16816(sum[f], a, b);
      }
      if constexpr (kGroups) {
        const int ke = k + 16 * (u + 1);   // a group or the piece ends here
        if (ke % group_size == 0 || ke == k_end)
          fold(acc, part, scales, (ke - 1) / group_size, nq, N, n_ok);
      }
    }
  }

  // the warp's partial tile: rows 2tq + e, columns 16g + c (c[e] of
  // fragment c / 2 for even c, c[e + 2] for odd)
  float* mine = red + warp * kRows * kLd;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      *reinterpret_cast<float4*>(mine + (2 * tq + e) * kLd + 16 * g +
                                 4 * c4) =
          make_float4(acc[2 * c4][e], acc[2 * c4][e + 2],
                      acc[2 * c4 + 1][e], acc[2 * c4 + 1][e + 2]);
  __syncthreads();

  // the CTA's tile, its warps' tiles added in warp order, straight into
  // the inbox of the CTA that reduces those columns (slice `owner` of the
  // 128 belongs to cluster rank `owner`), in this CTA's slot
  const int slice = kCols / splits, ld = slice + 4;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = tid; i < kRows * kCols / 4; i += blockDim.x) {
    const int r = i / (kCols / 4), c = 4 * (i % (kCols / 4));
    float4 v[kMaxWarps];
#pragma unroll
    for (int wi = 0; wi < kMaxWarps; ++wi)
      if (wi < warps)
        v[wi] = *reinterpret_cast<const float4*>(red + (wi * kRows + r) *
                                                 kLd + c);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int wi = 0; wi < kMaxWarps; ++wi)
      if (wi < warps)
        s.x += v[wi].x, s.y += v[wi].y, s.z += v[wi].z, s.w += v[wi].w;
    const int owner = c / slice;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(inbox, owner) +
                               (rank * kRows + r) * ld + c - owner * slice) =
        s;
  }
  cluster.sync();   // every CTA's slices are in their reducing CTAs

  // this CTA's columns: the cluster's tiles added in rank order
  for (int i = tid; i < kRows * slice / 4; i += blockDim.x) {
    const int r = i / (slice / 4), c = 4 * (i % (slice / 4));
    float4 v[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits)
        v[sp] = *reinterpret_cast<const float4*>(inbox + (sp * kRows + r) *
                                                 ld + c);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < splits)
        s.x += v[sp].x, s.y += v[sp].y, s.z += v[sp].z, s.w += v[sp].w;
    const int m = m0 + r, n = n0 + rank * slice + c;
    if (m < M && n < N) {
      if (!kGroups) {
        s.x *= scales[n], s.y *= scales[n + 1];
        s.z *= scales[n + 2], s.w *= scales[n + 3];
      }
      TX* o = out + static_cast<size_t>(m) * N + n;
      o[0] = ft5::from_float<TX>(s.x);
      o[1] = ft5::from_float<TX>(s.y);
      o[2] = ft5::from_float<TX>(s.z);
      o[3] = ft5::from_float<TX>(s.w);
    }
  }
}

// the decode form's plan (ops/quant.py::decode_plan): `splits` CTAs of a
// cluster along K, `warps` warps a CTA, k_piece K rows a warp
template <typename TX, typename TW>
cudaError_t launch(const TX* x, const TW* w, const float* scales, TX* out,
                   int M, int N, int K, int group_size, int splits,
                   int warps, int k_piece, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + kCols - 1) / kCols) * splits,
                     (M + kRows - 1) / kRows);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes =
      (warps * kRows * kLd + splits * kRows * (kCols / splits + 4)) *
      sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      group_size < K
          ? cudaLaunchKernelEx(&cfg, qmm_decode_kernel<TX, TW, true>, x, w,
                               scales, out, M, N, K, group_size, k_piece)
          : cudaLaunchKernelEx(&cfg, qmm_decode_kernel<TX, TW, false>, x, w,
                               scales, out, M, N, K, group_size, k_piece);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace dec

struct DecodePlan {
  int splits, warps, k_piece;
};

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const float* scales,
                   void* out, int M, int N, int K, int group_size,
                   const DecodePlan& plan, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       N % 16 == 0;
  if (M <= dec::kMaxM && aligned) {
    if (plan.splits < 1 || plan.splits > dec::kMaxSplits ||
        (plan.splits & (plan.splits - 1)) != 0 || plan.warps < 1 ||
        plan.warps > dec::kMaxWarps || plan.k_piece <= 0 ||
        plan.k_piece % 16 != 0 ||
        static_cast<long long>(plan.splits) * plan.warps * plan.k_piece < K)
      return cudaErrorInvalidValue;
    return dec::launch<TX, TW>(xp, wp, scales, op, M, N, K, group_size,
                               plan.splits, plan.warps, plan.k_piece, stream);
  }
  if (M > dec::kMaxM && aligned && std::is_same<TX, __nv_bfloat16>::value)
    return wg::launch<TW>(x, w, scales, out, M, N, K, group_size, stream);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(xp, wp, scales, op, M, N,
                                                    K, group_size);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_w(const void* x, const void* w, const float* scales,
                     void* out, int M, int N, int K, int group_size, int w_fp8,
                     const DecodePlan& plan, cudaStream_t stream) {
  if (w_fp8)
    return launch<TX, __nv_fp8_e4m3>(x, w, scales, out, M, N, K, group_size,
                                     plan, stream);
  return launch<TX, int8_t>(x, w, scales, out, M, N, K, group_size, plan,
                            stream);
}

}  // namespace

// x (M,K) in `x_dtype`; w (K,N) int8 or e4m3 bytes; scales (K/group_size, N)
// f32; out (M,N) in `x_dtype`. K and group_size multiples of 32. For M <=
// 32 (the decode form) splits, warps and k_piece are the K plan of
// ops/quant.py::decode_plan; other forms ignore them.
FT5_EXPORT int ft5_quant_matmul(const void* x, const void* w,
                                const float* scales, void* out, int M, int N,
                                int K, int group_size, int x_dtype, int w_fp8,
                                int splits, int warps, int k_piece,
                                void* stream) {
  if (K % kBK != 0 || group_size % kBK != 0 || K % group_size != 0)
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const DecodePlan plan{splits, warps, k_piece};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ft5::kFloat32)
    return launch_w<float>(x, w, scales, out, M, N, K, group_size, w_fp8,
                           plan, s);
  if (x_dtype == ft5::kBFloat16)
    return launch_w<__nv_bfloat16>(x, w, scales, out, M, N, K, group_size,
                                   w_fp8, plan, s);
  return cudaErrorInvalidValue;
}
