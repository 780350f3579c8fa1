// P1 and P2: the two probes of the JAX package's TPU tools, on the H100.
//
// P1 replaces tools/probe_program_cost.py:55 (the pallas_call of grids of
// N programs whose bodies differ only in their fixed work). On the card it
// is a per-block fixed-cost probe: grids of 16k-64k blocks of
// PROBE_THREADS threads whose body is empty (thread 0 writes one float),
// stages n floats in shared memory, or runs a chain of n dependent float
// multiply-adds per thread. It answers what the ~47,000 blocks of one K5
// launch cost before any arithmetic. Bound: the launch and block scheduling
// of the grid, not bytes or operations (both are a few MB or MFLOP).
//
// P2 replaces tools/probe_l2ica3.py:46 trivial_pallas_sum: the sum of each
// 8-row block of a 2-D array (a pyramid level after the blur). One block
// per 8-row block: strided per-thread sums, then block_sum2. Bound: bytes
// (each input float read once).
#include "common.cuh"

constexpr int PROBE_THREADS = 128;

__global__ void cta_empty_kernel(float* __restrict__ out) {
  if (threadIdx.x == 0) out[blockIdx.x] = (float)blockIdx.x;
}

__global__ void cta_stage_kernel(const float* __restrict__ in, int n,
                                 float* __restrict__ out) {
  extern __shared__ float buf[];
  const float* src = in + (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = src[i];
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = buf[n - 1];
}

__global__ void cta_chain_kernel(const float* __restrict__ in, int n,
                                 float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  float x = in[i];
  for (int k = 0; k < n; ++k) x = x * 1.000001f + 0.000001f;
  out[i] = x;
}

// kind 0: empty body; 1: stage n floats of `in` per block; 2: a chain of n
// multiply-adds per thread on in[block * PROBE_THREADS + thread].
extern "C" int hmsr_cta_probe(int kind, const float* in, int n, float* out,
                              int n_blocks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_blocks <= 0) return (int)cudaGetLastError();
  switch (kind) {
    case 0:
      cta_empty_kernel<<<n_blocks, PROBE_THREADS, 0, st>>>(out);
      break;
    case 1:
      if (n < 1 || n > 12 * 1024) return (int)cudaErrorInvalidValue;
      cta_stage_kernel<<<n_blocks, PROBE_THREADS, n * sizeof(float), st>>>(
          in, n, out);
      break;
    case 2:
      cta_chain_kernel<<<n_blocks, PROBE_THREADS, 0, st>>>(in, n, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Block-wide sum of (s0, s1) for blockDim.x a multiple of 32 (at most
// 1024): warp shuffles, then thread 0 adds the warps' sums in order. The
// result is valid in thread 0 only.
__device__ __forceinline__ void block_sum2(float& s0, float& s1,
                                           float (*red)[32]) {
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, o);
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s0;
    red[1][warp] = s1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      t0 += red[0][i];
      t1 += red[1][i];
    }
    s0 = t0;
    s1 = t1;
  }
}

__global__ void row_block_sum_kernel(const float* __restrict__ x, int h, int w,
                                     float* __restrict__ out) {
  __shared__ float red[2][32];
  const int y0 = blockIdx.x * 8;
  const int rows = min(8, h - y0);
  const float* src = x + (size_t)y0 * w;
  float s0 = 0.0f, s1 = 0.0f;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) s0 += src[i];
  block_sum2(s0, s1, red);
  if (threadIdx.x == 0) out[blockIdx.x] = s0;
}

// out[b] = sum of rows 8b .. 8b+7 of the (h, w) array x (fewer in the last).
extern "C" int hmsr_row_block_sum(const float* x, int h, int w, float* out,
                                  void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  row_block_sum_kernel<<<(h + 7) / 8, 256, 0, (cudaStream_t)stream>>>(x, h, w,
                                                                     out);
  return (int)cudaGetLastError();
}
