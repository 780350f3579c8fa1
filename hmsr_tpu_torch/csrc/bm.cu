// K1: tile block matching — exhaustive (2r+1)^2 search around round(flow).
//
// Replaces hmsr_tpu/ops/pallas_ica.py:_bm_kernel (launched by _bm_run through
// bm_pallas). Returns the integer displacement (dx, dy) of the first minimum
// per tile; the caller applies the metric's flow update (L1: round(flow)+d,
// L2: flow+d).
//   metric 0 (L1): cost sum |ref - win|, out-of-bounds pixels read 0;
//   metric 1 (L2): cost sum win^2 - 2 sum ref*win, coordinates edge-clamped.
//
// Bound on the H100: arithmetic. At L2 r=4 each tile costs 81*ts^2
// multiply-adds (x2 for the window norm) against (ts+8)^2 + ts^2 floats read
// once, so it is bound by the FP32 pipes and shared-memory reads, not by
// device memory. Design: one block per tile; the search window and the
// reference tile are staged once in shared memory (bm_stage); one thread per
// candidate sums its cost over the tile (bm_cost, the exact summation order
// of the plain version, so argmins are bit-identical to it); thread 0 takes
// the first minimum in row-major (sy, sx) order (first_min). No atomics.
#include "common.cuh"

__global__ void bm_kernel(const float* __restrict__ ref, int rs0, int rs1,
                          int rs2, int rs3, const float* __restrict__ mov,
                          int h, int w, const float* __restrict__ flow, int nx,
                          int ts, int r, int metric, int* __restrict__ disp) {
  extern __shared__ float sm[];
  const int n_sh = 2 * r + 1;
  const int nc = n_sh * n_sh;
  const int sw = ts + 2 * r;
  float* win = sm;                // sw * sw search window
  float* reft = win + sw * sw;    // ts * ts reference tile
  float* cost = reft + ts * ts;   // nc candidate costs

  const int tile = blockIdx.x;
  const int ty = tile / nx;
  const int tx = tile - ty * nx;
  const int top = ty * ts + __float2int_rn(flow[2 * tile + 1]) - r;
  const int left = tx * ts + __float2int_rn(flow[2 * tile]) - r;
  bm_stage(win, reft, ref + (size_t)ty * rs0 + (size_t)tx * rs1, rs2, rs3,
           mov, h, w, top, left, sw, ts, metric);
  __syncthreads();

  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    cost[c] = bm_cost(win, reft, sw, ts, c / n_sh, c % n_sh, metric);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int best = first_min(cost, nc);
    disp[2 * tile] = best % n_sh - r;
    disp[2 * tile + 1] = best / n_sh - r;
  }
}

extern "C" int hmsr_block_match(const float* ref, int rs0, int rs1, int rs2,
                                int rs3, const float* mov, int h, int w,
                                const float* flow, int ny, int nx, int ts,
                                int r, int metric, int* disp, void* stream) {
  const int nc = (2 * r + 1) * (2 * r + 1);
  const int sw = ts + 2 * r;
  const size_t smem = sizeof(float) * (size_t)(sw * sw + ts * ts + nc);
  int threads = ((nc + 31) / 32) * 32;
  if (threads < 64) threads = 64;
  if (threads > 256) threads = 256;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (ny > 0 && nx > 0) {
    bm_kernel<<<ny * nx, threads, smem, (cudaStream_t)stream>>>(
        ref, rs0, rs1, rs2, rs3, mov, h, w, flow, nx, ts, r, metric, disp);
  }
  return (int)cudaGetLastError();
}
