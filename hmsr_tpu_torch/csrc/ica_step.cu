// K2: one Gauss-Newton step of the ICA (inverse-compositional Lucas-Kanade)
// refinement, per tile: b = sum -grad_ref * (warp(moving) - ref).
//
// Replaces hmsr_tpu/ops/pallas_ica.py:_ica_step_kernel (launched by
// _ica_step_run through ica_step_pallas, looped by _gn_iterations). The 2x2
// solve and the |det| < 1e-10 keep-flow rule stay outside, as torch ops.
// Semantics of hmsr_tpu/models/ica.py:refine_ica_tiled: the flow is split by
// truncation toward zero (negative flows give negative fractions), the
// bilinear taps read 0 out of bounds, and zero taps still contribute
// gradt = -ref.
//
// Bound on the H100: device memory. Per tile it reads ~(ts+1)^2 moving
// pixels and 3 ts^2 reference planes (ref, gx, gy) for ~20 flops a pixel,
// far below the card's flop/byte balance. Design: one block per tile, one
// thread per tile pixel (looping when ts^2 > 256); the four taps come
// straight from global memory (neighbouring threads read neighbouring
// addresses, and the L1 cache serves the 4-fold tap reuse); a warp-shuffle +
// shared-memory block reduction gives (b0, b1). No atomics. The per-thread
// sums and the reduction (ica_partial, block_sum2 in common.cuh) are shared
// with K3, which runs the same step n_iter times in one launch.
#include "common.cuh"

__global__ void ica_step_kernel(const float* __restrict__ ref,
                                const float* __restrict__ gx,
                                const float* __restrict__ gy, int ref_w,
                                const float* __restrict__ mov, int h, int w,
                                const float* __restrict__ flow, int nx, int ts,
                                float* __restrict__ b) {
  __shared__ float red[2][32];
  const int tile = blockIdx.x;
  const int ty = tile / nx;
  const int tx = tile - ty * nx;
  float s0, s1;
  ica_partial(ref, gx, gy, ref_w, mov, h, w, ty, tx, ts, flow[2 * tile],
              flow[2 * tile + 1], s0, s1);
  block_sum2(s0, s1, red);
  if (threadIdx.x == 0) {
    b[2 * tile] = s0;
    b[2 * tile + 1] = s1;
  }
}

extern "C" int hmsr_ica_step(const float* ref, const float* gx,
                             const float* gy, int ref_w, const float* mov,
                             int h, int w, const float* flow, int ny, int nx,
                             int ts, float* b, void* stream) {
  if (ny > 0 && nx > 0) {
    ica_step_kernel<<<ny * nx, ica_threads(ts), 0, (cudaStream_t)stream>>>(
        ref, gx, gy, ref_w, mov, h, w, flow, nx, ts, b);
  }
  return (int)cudaGetLastError();
}
