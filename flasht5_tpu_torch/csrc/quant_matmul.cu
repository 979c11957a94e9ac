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
// tensor-core rate does. So there are two forms, chosen by M:
//
// - qmm_kernel, the tensor-core form for M > 32: 64x64 output tiles per
//   CTA, four warps of 32x32, K in steps of 32 staged through shared memory
//   as bf16, mma.sync.m16n8k16 bf16 -> fp32.
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
// size), which the wrapper checks. TMA loads, a stage ring and wgmma for
// the tensor-core form, and a split over K for the decode form, are later
// steps.

#include "common.cuh"

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

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

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
  if (skinny) {
    dim3 grid((N + kSkBN - 1) / kSkBN, (M + kSkBM - 1) / kSkBM);
    qmm_skinny_kernel<TX, TW><<<grid, kSkThreads, 0, stream>>>(
        xp, wp, scales, op, M, N, K, group_size);
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
