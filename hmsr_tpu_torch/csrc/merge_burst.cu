// K5': burst-fused merge accumulation of F non-reference frames (Alg. 4) into
// (num, den), the accumulators read and written once per launch.
//
// Replaces hmsr_tpu/ops/pallas_merge.py:_merge_group_kernel as launched by
// merge_burst_pallas (frames grid, F > 1; through _merge_frames_pallas and
// its pallas_call). Semantics: F sequential K5 launches, bit for bit. Each
// frame's contribution is merge_pixel (common.cuh), the function K5 calls,
// and it is added to the running sums in frame order (acc = acc + vals_f),
// the additions K5 makes to num/den in memory.
//
// Bound on the H100: device memory. Per chunk the accumulators cost 48 bytes
// per HR pixel once (read and write of 6 floats) instead of once per frame,
// plus each frame's inputs (raw frame and robustness, 8 bytes per raw pixel;
// covariances, 12 bytes per grey pixel): 2.30 GB + F x 0.13 GB at 3000x4000
// x2, against ~120 flops per HR pixel and frame. Design: one thread per HR
// pixel, which loads its six accumulator values into registers, loops over
// the frames and stores once; no atomics, no shared memory. Raw, covariance
// and robustness taps come through the caches as in K5. Staging the tile
// windows in shared memory is left for later.
#include "common.cuh"

__global__ void merge_burst_kernel(const float* __restrict__ comp, int F,
                                   int H, int W,
                                   const float* __restrict__ flow, int fny,
                                   int fnx, const float* __restrict__ covs,
                                   int gh, int gw,
                                   const float* __restrict__ rob,
                                   float* __restrict__ num,
                                   float* __restrict__ den, int out_h,
                                   int out_w, int Ts, int s, int cfa00,
                                   int cfa01, int cfa10, int cfa11) {
  const int C = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = blockIdx.y;
  if (C >= out_w) return;
  const size_t plane = (size_t)out_h * out_w;
  const size_t o = (size_t)R * out_w + C;
  float n[3], d[3];
  for (int k = 0; k < 3; ++k) {
    n[k] = num[k * plane + o];
    d[k] = den[k * plane + o];
  }
  const size_t raw_frame = (size_t)H * W;
  const size_t flow_frame = (size_t)fny * fnx * 2;
  const size_t cov_frame = (size_t)3 * gh * gw;
  for (int f = 0; f < F; ++f) {
    float vals[3], accs[3];
    merge_pixel(comp + f * raw_frame, H, W, flow + f * flow_frame, fnx,
                covs + f * cov_frame, gh, gw, rob + f * raw_frame, R, C, Ts, s,
                cfa00, cfa01, cfa10, cfa11, vals, accs);
    for (int k = 0; k < 3; ++k) {
      n[k] = n[k] + vals[k];
      d[k] = d[k] + accs[k];
    }
  }
  for (int k = 0; k < 3; ++k) {
    num[k * plane + o] = n[k];
    den[k * plane + o] = d[k];
  }
}

extern "C" int hmsr_merge_burst(const float* comp, int F, int H, int W,
                                const float* flow, int fny, int fnx,
                                const float* covs, int gh, int gw,
                                const float* rob, float* num, float* den,
                                int out_h, int out_w, int Ts, int s, int cfa00,
                                int cfa01, int cfa10, int cfa11,
                                void* stream) {
  const int threads = 256;
  dim3 grid((out_w + threads - 1) / threads, out_h);
  if (F > 0 && out_h > 0 && out_w > 0) {
    merge_burst_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        comp, F, H, W, flow, fny, fnx, covs, gh, gw, rob, num, den, out_h,
        out_w, Ts, s, cfa00, cfa01, cfa10, cfa11);
  }
  return (int)cudaGetLastError();
}
