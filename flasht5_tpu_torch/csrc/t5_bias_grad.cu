// The gradient of the T5 bucket table through the materialized bias:
// dW[b, h] = sum of dbias[h, i, j] over every (i, j) whose bucket is b.
//
// Replaces no TPU kernel: the JAX package leaves the gather's gradient
// (`jnp.take` in flasht5_tpu/positional.py::t5_relative_bias) to XLA's
// scatter-add. In PyTorch that backward is the sorting
// `index_put_(accumulate=True)`, which adds each bucket's tens of thousands
// of duplicates one after the other; this file takes its place on the card
// (ops/t5_bias_grad.py, called by positional.py's `_BucketGather`).
//
// Bound on the H100: bytes. The work is one read of the (H, M, N) f32
// dbias (the encoder's (8, 1024, 1024) is 33.6 MB: 0.0100 ms at 3.35 TB/s),
// a read of the (M, N) int32 bucket map a head, and an addition an element.
//
// The same contract as the attention backward's dW
// (csrc/flash_attention_bwd.cu): f32 sums, no global float atomics, the same
// bits on every run. One route for default and explicit positions alike: a
// CTA takes a chunk of one head's (M, N) entries and the bucket map of the
// same entries; each thread adds its entries, in order, into its own column
// of num_buckets bins in shared memory, and the bins are summed across
// threads in a fixed order into the CTA's row of num_buckets sums. A second
// launch sums each head's rows in order into dW (num_buckets, H).
// num_buckets <= kMaxBuckets (the bins, 128 KB at 256).

#include "common.cuh"

namespace {

constexpr int kMaxBuckets = 256;
constexpr int kThreads = 128;
constexpr int kChunk = 8192;                 // entries of a CTA

// grid (ceil(M N / kChunk), H); part (H, gridDim.x, nb). Dynamic shared
// memory: nb x kThreads bins, then kThreads floats.
__global__ void __launch_bounds__(kThreads)
    bias_grad_map_kernel(const float* __restrict__ grad,
                         const int* __restrict__ map, size_t MN, int nb,
                         float* __restrict__ part) {
  extern __shared__ float smem[];
  float* bins = smem;                        // bins[b * kThreads + tid]
  float* scratch = smem + nb * kThreads;
  const int tid = threadIdx.x;
  const float* g = grad + static_cast<size_t>(blockIdx.y) * MN;
  for (int b = 0; b < nb; ++b) bins[b * kThreads + tid] = 0.f;
  const size_t begin = static_cast<size_t>(blockIdx.x) * kChunk;
  const size_t end = MN - begin < kChunk ? MN : begin + kChunk;
  for (size_t e = begin + tid; e < end; e += kThreads) {
    const int b = __ldg(map + e);
    if (static_cast<unsigned>(b) < static_cast<unsigned>(nb))
      bins[b * kThreads + tid] += __ldg(g + e);
  }
  __syncthreads();
  // across threads: `parts` threads a bucket, a power of two that divides
  // kThreads, each sum a contiguous share of the columns (in a rotated
  // order, so a warp's reads meet distinct banks); then one thread adds the
  // shares in order
  int parts = 1;
  while (2 * parts * nb <= kThreads) parts *= 2;
  const int chunk = kThreads / parts;
  float* out = part + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                       blockIdx.x) * nb;
  for (int idx = tid; idx < nb * parts; idx += kThreads) {
    const int b = idx / parts, p = idx - b * parts;
    const float* col = bins + b * kThreads + p * chunk;
    float acc = 0.f;
    for (int s = 0; s < chunk; ++s) acc += col[(s + idx) % chunk];
    if (parts > 1) scratch[idx] = acc;
    else out[b] = acc;
  }
  if (parts == 1) return;
  __syncthreads();
  for (int b = tid; b < nb; b += kThreads) {
    float acc = 0.f;
    for (int p = 0; p < parts; ++p) acc += scratch[b * parts + p];
    out[b] = acc;
  }
}

// dw[b, h] = sum over p in order of part[h, p, b]
__global__ void bias_grad_combine_kernel(const float* __restrict__ part,
                                         int P, int H, int nb,
                                         float* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nb * H) return;
  const int b = idx / H, h = idx - b * H;
  const float* src = part + static_cast<size_t>(h) * P * nb + b;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc += src[static_cast<size_t>(p) * nb];
  dw[idx] = acc;
}

int parts_of(int M, int N) {
  const long long mn = static_cast<long long>(M) * N;
  return static_cast<int>((mn + kChunk - 1) / kChunk);
}

}  // namespace

// The number of partial rows a head of the given shape takes: the wrapper
// allocates `part` as (H, parts, num_buckets) f32.
FT5_EXPORT int ft5_t5_bias_grad_parts(int M, int N) { return parts_of(M, N); }

// grad (H, M, N) f32, contiguous; bucket (M, N) int32, contiguous; part
// (H, parts, num_buckets) f32 scratch; dw (num_buckets, H) f32, written.
// 1 <= num_buckets <= 256.
FT5_EXPORT int ft5_t5_bias_grad(const float* grad, const int* bucket,
                                float* part, float* dw, int H, int M, int N,
                                int num_buckets, void* stream) {
  if (num_buckets < 1 || num_buckets > kMaxBuckets || H < 1 || M < 1 ||
      N < 1 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = parts_of(M, N);
  const size_t smem =
      (static_cast<size_t>(num_buckets) + 1) * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bias_grad_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bias_grad_map_kernel<<<dim3(P, H), kThreads, smem, st>>>(
      grad, bucket, static_cast<size_t>(M) * N, num_buckets, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = num_buckets * H;
  bias_grad_combine_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part, P, H, num_buckets, dw);
  return cudaGetLastError();
}
