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
// call:
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
// - qmm_skinny_kernel, the decode form for M <= 32 (with N % 4 == 0 and
//   aligned x and W): a 64x64 tile would give a 512-wide projection 8 CTAs,
//   each walking K one latency-bound step at a time, on a card of 132 SMs.
//   Instead each CTA owns 32 columns and 8 rows of x; its 256 threads stream
//   the weight slice with 4-byte loads, eight threads per weight row, 32
//   rows at a time and eight such bands of loads in flight per thread, on
//   the CUDA cores (at M <= 32 the products are too few for the tensor cores
//   to matter). Each thread keeps 8 x 4 fp32 sums; warp shuffles and shared
//   memory reduce them over the 32 rows of a band.
//
// Ragged M and N are masked; K must be a multiple of 32 (and of the group
// size), which the wrapper checks. A split over K for the decode form is a
// later step.

#include "common.cuh"
#include "mma.cuh"

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

template <int R>
__device__ __forceinline__ void fence_all(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) ft5::mma::fence_regs(r[i]);
}

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

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (no link against libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// a row-major (rows, cols) array of `elem` bytes, boxes of (box_rows,
// box_cols), zeros outside
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
              int rows, int cols, int elem, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
// Decode form
// ---------------------------------------------------------------------------

constexpr int kSkMaxM = 32;      // largest M that takes the decode form
constexpr int kSkBM = 8;         // x rows per CTA
constexpr int kSkBN = 32;        // output columns per CTA
constexpr int kSkLanes = 32;     // weight rows per band (one per 8 threads)
constexpr int kSkKC = 1024;      // x columns staged in shared memory at once
constexpr int kSkThreads = 256;  // (kSkBN / 4) threads per row x kSkLanes
constexpr int kSkLoads = 8;      // 4-byte weight loads in flight per thread

template <typename TX, typename TW>
__global__ void __launch_bounds__(kSkThreads)
qmm_skinny_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                  const float* __restrict__ scales, TX* __restrict__ out,
                  int M, int N, int K, int group_size) {
  __shared__ float xs[kSkBM][kSkKC];                       // x, bf16-rounded
  __shared__ float red[kSkThreads / 32][kSkBM][kSkBN];     // per-warp sums

  const int tid = threadIdx.x;
  const int tx = tid & 7;          // which 4 columns
  const int ty = tid >> 3;         // which weight row lane
  const int n0 = blockIdx.x * kSkBN, m0 = blockIdx.y * kSkBM;
  const int n = n0 + tx * 4;       // N % 4 == 0: four columns all in or out
  const bool n_ok = n < N;

  float part[kSkBM][4], acc[kSkBM][4];
#pragma unroll
  for (int m = 0; m < kSkBM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[m][j] = acc[m][j] = 0.f;

  for (int kc = 0; kc < K; kc += kSkKC) {
    const int klen = min(kSkKC, K - kc);   // a multiple of 32
    __syncthreads();                       // the previous chunk is read
    // x rows in 16-byte loads (x is 16-byte aligned and K a multiple of 32)
    constexpr int kVec = 16 / sizeof(TX);
    const int row_vecs = klen / kVec;
#pragma unroll 4
    for (int idx = tid; idx < kSkBM * row_vecs; idx += kSkThreads) {
      const int r = idx / row_vecs, c = (idx - r * row_vecs) * kVec;
      const int m = m0 + r;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        raw = *reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(m) * K + kc + c);
      const TX* e = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        xs[r][c + i] = ft5::round_bf16(ft5::to_float(e[i]));
    }
    __syncthreads();
    // kSkLoads bands of weight rows per batch: all their loads are issued
    // before the first product, so each batch costs one memory latency
    for (int b0 = 0; b0 < klen; b0 += kSkLanes * kSkLoads) {
      uint32_t raw[kSkLoads];
#pragma unroll
      for (int u = 0; u < kSkLoads; ++u) {
        const int kk = b0 + u * kSkLanes + ty;
        raw[u] = n_ok && kk < klen
                     ? *reinterpret_cast<const uint32_t*>(
                           w + static_cast<size_t>(kc + kk) * N + n)
                     : 0u;
      }
#pragma unroll
      for (int u = 0; u < kSkLoads; ++u) {
        const int band = b0 + u * kSkLanes;   // first row of this band
        if (band >= klen) break;
        const TW* e = reinterpret_cast<const TW*>(&raw[u]);
        float wf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wf[j] = weight_to_float(e[j]);
#pragma unroll
        for (int m = 0; m < kSkBM; ++m) {
          const float xv = xs[m][band + ty];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[m][j] += xv * wf[j];
        }
        // a band that ends on a group boundary closes that scale group
        const int band_end = kc + band + kSkLanes;
        if (band_end % group_size == 0) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          if (n_ok) {
            const float* srow = scales +
                static_cast<size_t>(band_end / group_size - 1) * N + n;
#pragma unroll
            for (int j = 0; j < 4; ++j) s[j] = srow[j];
          }
#pragma unroll
          for (int m = 0; m < kSkBM; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[m][j] += part[m][j] * s[j];
              part[m][j] = 0.f;
            }
        }
      }
    }
  }

  // sum over the 32 row lanes: the 4 lanes of a warp by shuffles, the 8
  // warps through shared memory
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int m = 0; m < kSkBM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[warp][m][tx * 4 + j] = v;
    }
  __syncthreads();
  {
    const int m = tid / kSkBN, c = tid - m * kSkBN;   // one output per thread
    float total = 0.f;
#pragma unroll
    for (int wi = 0; wi < kSkThreads / 32; ++wi) total += red[wi][m][c];
    if (m0 + m < M && n0 + c < N)
      out[static_cast<size_t>(m0 + m) * N + n0 + c] =
          ft5::from_float<TX>(total);
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const float* scales,
                   void* out, int M, int N, int K, int group_size,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const bool skinny = M <= kSkMaxM && N % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool tma = std::is_same<TX, __nv_bfloat16>::value && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (skinny) {
    dim3 grid((N + kSkBN - 1) / kSkBN, (M + kSkBM - 1) / kSkBM);
    qmm_skinny_kernel<TX, TW><<<grid, kSkThreads, 0, stream>>>(
        xp, wp, scales, op, M, N, K, group_size);
  } else if (tma) {
    return wg::launch<TW>(x, w, scales, out, M, N, K, group_size, stream);
  } else {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    qmm_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(xp, wp, scales, op, M,
                                                      N, K, group_size);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_w(const void* x, const void* w, const float* scales,
                     void* out, int M, int N, int K, int group_size, int w_fp8,
                     cudaStream_t stream) {
  if (w_fp8)
    return launch<TX, __nv_fp8_e4m3>(x, w, scales, out, M, N, K, group_size,
                                     stream);
  return launch<TX, int8_t>(x, w, scales, out, M, N, K, group_size, stream);
}

}  // namespace

// x (M,K) in `x_dtype`; w (K,N) int8 or e4m3 bytes; scales (K/group_size, N)
// f32; out (M,N) in `x_dtype`. K and group_size multiples of 32.
FT5_EXPORT int ft5_quant_matmul(const void* x, const void* w,
                                const float* scales, void* out, int M, int N,
                                int K, int group_size, int x_dtype, int w_fp8,
                                void* stream) {
  if (K % kBK != 0 || group_size % kBK != 0 || K % group_size != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == ft5::kFloat32)
    return launch_w<float>(x, w, scales, out, M, N, K, group_size, w_fp8, s);
  if (x_dtype == ft5::kBFloat16)
    return launch_w<__nv_bfloat16>(x, w, scales, out, M, N, K, group_size,
                                   w_fp8, s);
  return cudaErrorInvalidValue;
}
