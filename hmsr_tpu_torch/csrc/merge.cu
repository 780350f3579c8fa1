// K5: merge accumulation of one non-reference frame (Alg. 4) into (num, den).
//
// Replaces hmsr_tpu/ops/pallas_merge.py:_merge_group_kernel (launched by
// _merge_frames_pallas through merge_pallas). The per-pixel arithmetic is
// merge_pixel in common.cuh, shared with K5' (merge_burst.cu).
//
// Bound on the H100: device memory — per HR pixel a read-modify-write of 6
// accumulator floats (48 bytes) against ~120 flops. Design: one thread per HR
// pixel; each thread owns its num/den entries, so the in-place update has no
// race and needs no atomics; raw, covariance and robustness taps are shared
// by neighbouring threads through the caches.
#include "common.cuh"

__global__ void merge_kernel(const float* __restrict__ comp, int H, int W,
                             const float* __restrict__ flow, int fnx,
                             const float* __restrict__ covs, int gh, int gw,
                             const float* __restrict__ rob,
                             float* __restrict__ num, float* __restrict__ den,
                             int out_h, int out_w, int Ts, int s, int cfa00,
                             int cfa01, int cfa10, int cfa11) {
  const int C = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = blockIdx.y;
  if (C >= out_w) return;
  float vals[3], accs[3];
  merge_pixel(comp, H, W, flow, fnx, covs, gh, gw, rob, R, C, Ts, s, cfa00,
              cfa01, cfa10, cfa11, vals, accs);
  const size_t plane = (size_t)out_h * out_w;
  const size_t o = (size_t)R * out_w + C;
  for (int k = 0; k < 3; ++k) {
    num[k * plane + o] += vals[k];
    den[k * plane + o] += accs[k];
  }
}

extern "C" int hmsr_merge(const float* comp, int H, int W, const float* flow,
                          int fnx, const float* covs, int gh, int gw,
                          const float* rob, float* num, float* den, int out_h,
                          int out_w, int Ts, int s, int cfa00, int cfa01,
                          int cfa10, int cfa11, void* stream) {
  const int threads = 256;
  dim3 grid((out_w + threads - 1) / threads, out_h);
  if (out_h > 0 && out_w > 0) {
    merge_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        comp, H, W, flow, fnx, covs, gh, gw, rob, num, den, out_h, out_w, Ts,
        s, cfa00, cfa01, cfa10, cfa11);
  }
  return (int)cudaGetLastError();
}
