// K3: all n_iter Gauss-Newton steps of the ICA refinement of a tile in one
// launch, optionally after an L1 radius-1 block-matching search.
//
// Replaces hmsr_tpu/ops/pallas_ica_fused.py:_ica_kernel (launched by
// _refine_fused_impl through refine_ica_pallas / match_l1_refine_ica_fused).
// The JAX package runs it on levels with fewer than 2000 tiles, where the
// TPU's per-launch overhead dominates. Semantics: with bm = 1, the L1 search
// of K1 (window at round(flow), zero fill, first minimum) and the flow
// replaced by round(flow) + d; then n_iter times: b as K2 computes it, the
// 2x2 solve with the precomputed Hessian terms, and the flow kept as it is
// on tiles whose |det| < 1e-10 (det_inv == 0).
//
// Bound on the H100: on the levels it runs (a few hundred to two thousand
// tiles) it is bound by latency, not by a roofline: one block per tile fills
// only a fraction of the 132 SMs, and each step is a dependent chain of
// loads, a block reduction and a scalar solve. The design removes what the
// unfused path adds on top of that chain: 1 + n_iter launches and the
// torch-side solves (about 8 small elementwise launches per iteration)
// become one launch, the flow lives in shared memory between iterations,
// and the per-step sums and the reduction are K2's own device code
// (ica_partial, block_sum2), so b is bit-identical to K2's. The search
// reuses K1's device code (bm_stage, bm_cost, first_min). No atomics.
#include "common.cuh"

__global__ void ica_fused_kernel(const float* __restrict__ ref,
                                 const float* __restrict__ gx,
                                 const float* __restrict__ gy, int ref_w,
                                 const float* __restrict__ mov, int h, int w,
                                 const float* __restrict__ flow_in,
                                 const float* __restrict__ terms, int nx,
                                 int ts, int n_iter, int bm,
                                 float* __restrict__ flow_out) {
  extern __shared__ float sm[];  // bm: (ts+2)^2 window, ts^2 tile, 9 costs
  __shared__ float red[2][32];
  __shared__ float fl[2];
  const int tile = blockIdx.x;
  const int ty = tile / nx;
  const int tx = tile - ty * nx;

  if (bm) {
    const int sw = ts + 2;
    float* win = sm;
    float* reft = win + sw * sw;
    float* cost = reft + ts * ts;
    const float rx = rintf(flow_in[2 * tile]);  // half to even
    const float ry = rintf(flow_in[2 * tile + 1]);
    bm_stage(win, reft, ref + (size_t)ty * ts * ref_w + (size_t)tx * ts,
             ref_w, 1, mov, h, w, ty * ts + (int)ry - 1, tx * ts + (int)rx - 1,
             sw, ts, 0);
    __syncthreads();
    if (threadIdx.x < 9) {
      cost[threadIdx.x] =
          bm_cost(win, reft, sw, ts, threadIdx.x / 3, threadIdx.x % 3, 0);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int best = first_min(cost, 9);
      fl[0] = rx + (float)(best % 3 - 1);
      fl[1] = ry + (float)(best / 3 - 1);
    }
  } else if (threadIdx.x == 0) {
    fl[0] = flow_in[2 * tile];
    fl[1] = flow_in[2 * tile + 1];
  }
  __syncthreads();

  const float* t = terms + 5 * (size_t)tile;  // det_inv, a00, a01, a10, a11
  for (int it = 0; it < n_iter; ++it) {
    const float ax = fl[0];
    const float ay = fl[1];
    float b0, b1;
    ica_partial(ref, gx, gy, ref_w, mov, h, w, ty, tx, ts, ax, ay, b0, b1);
    block_sum2(b0, b1, red);
    if (threadIdx.x == 0 && t[0] != 0.0f) {
      const float dx = t[0] * (t[4] * b0 - t[2] * b1);
      const float dy = t[0] * (-t[3] * b0 + t[1] * b1);
      fl[0] = ax + dx;
      fl[1] = ay + dy;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    flow_out[2 * tile] = fl[0];
    flow_out[2 * tile + 1] = fl[1];
  }
}

extern "C" int hmsr_ica_fused(const float* ref, const float* gx,
                              const float* gy, int ref_w, const float* mov,
                              int h, int w, const float* flow_in,
                              const float* terms, int ny, int nx, int ts,
                              int n_iter, int bm, float* flow_out,
                              void* stream) {
  const size_t smem =
      bm ? sizeof(float) * (size_t)((ts + 2) * (ts + 2) + ts * ts + 9) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ica_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (ny > 0 && nx > 0) {
    ica_fused_kernel<<<ny * nx, ica_threads(ts), smem, (cudaStream_t)stream>>>(
        ref, gx, gy, ref_w, mov, h, w, flow_in, terms, nx, ts, n_iter, bm,
        flow_out);
  }
  return (int)cudaGetLastError();
}
