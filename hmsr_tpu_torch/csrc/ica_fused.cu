// K3: all n_iter Gauss-Newton steps of the ICA refinement of a tile in one
// launch, optionally after an L1 radius-1 block-matching search.
//
// Replaces hmsr_tpu/ops/pallas_ica_fused.py:_ica_kernel (launched by
// _refine_fused_impl through refine_ica_pallas / match_l1_refine_ica_fused).
// The JAX package runs it on levels with fewer than 2000 tiles, where the
// TPU's per-launch overhead dominates. Semantics: with bm = 1, the L1 search
// of K1 (window at round(flow), zero fill, first minimum) and the flow
// replaced by round(flow) + d; then n_iter times: b, the 2x2 solve with the
// tile's terms, and the flow kept as it is on tiles whose |det| < 1e-10
// (det_inv == 0).
//
// Bound on the H100: on the levels it runs (6 to 2,000 tiles) it is bound
// by latency, not by a roofline (its bytes take under 1 us): one launch of
// a dependent chain per tile, loads, a reduction and a scalar solve per
// step.
//
// What held the first design back (one block of up to 256 threads per
// tile, ~0.013 ms a frame): the step's reduction ended in a block barrier
// and a serial sum of the warps in thread 0, the flow went through shared
// memory behind another barrier each step, every step re-read ref, gx and
// gy with bounds-tested taps from global memory, and the search ran its 9
// candidate costs on 9 threads while the rest of a 256-thread block
// waited.
//
// This design: one block per tile, of the tile's lanes (ica_layout): one
// warp at ts <= 16, the main path's K3 levels, so neither the search nor
// the steps need a block barrier there. The lane's reference pixels and the
// terms are loaded into registers first, so their loads overlap the search;
// the steps are K2's own code (IcaTile in common.cuh: window staged in
// shared memory, xor-shuffle reduction, solve in every lane), with the same
// lanes per tile, so K3 without its search equals K2 bit for bit. The
// search stages its (ts+2)^2 window and the reference tile once (K1's
// bm_stage, zero fill) and sums each of the 9 candidates on a lane of its
// own in row-major order (bm_cost: the summation of block_match_plain, so
// the costs, and the argmin, are bit-identical to it); every lane then
// picks the first minimum of the 9 staged costs (first_min) for itself. No
// atomics.
#include "common.cuh"

// TS == 0: ts at run time.
template <int TS>
__global__ void __launch_bounds__(ICA_MAX_LANES)
    ica_fused_kernel(IcaLevel lv, const float* __restrict__ flow_in,
                     const float* __restrict__ terms, int nx, int ts_rt,
                     int n_iter, int bm, float* __restrict__ flow_out) {
  const int ts = TS > 0 ? TS : ts_rt;
  const IcaLayout L = ica_layout(ts, 0, bm != 0);
  extern __shared__ float sm[];
  const int g = threadIdx.x;
  const int tile = blockIdx.x;
  const int ty = tile / nx;
  const int tx = tile - ty * nx;
  IcaTile<TS> t;
  t.load(lv, ts_rt, ty, tx, g, terms + 5 * (size_t)tile);
  float2 fl = make_float2(flow_in[2 * tile], flow_in[2 * tile + 1]);
  if (bm) {
    const int sw = ts + 2;
    float* win = sm;
    float* reft = win + sw * sw;
    float* cost = reft + ts * ts;
    const float rx = rintf(fl.x);  // half to even
    const float ry = rintf(fl.y);
    bm_stage(win, reft, lv.ref + (size_t)ty * ts * lv.ref_w + (size_t)tx * ts,
             lv.ref_w, 1, lv.mov, lv.h, lv.w, ty * ts + (int)ry - 1,
             tx * ts + (int)rx - 1, sw, ts, 0);
    ica_tile_sync(L.lanes >> 5);
    if (g < 9) cost[g] = bm_cost(win, reft, sw, ts, g / 3, g % 3, 0);
    ica_tile_sync(L.lanes >> 5);
    const int best = first_min(cost, 9);
    fl = make_float2(rx + (float)(best % 3 - 1), ry + (float)(best / 3 - 1));
  }
  fl = t.steps(lv, fl, n_iter, sm, sm + L.stage);
  if (g == 0) {
    flow_out[2 * tile] = fl.x;
    flow_out[2 * tile + 1] = fl.y;
  }
}

template <int TS>
static int launch_fused(const IcaLevel& lv, const float* flow_in,
                        const float* terms, int ny, int nx, int ts, int n_iter,
                        int bm, float* flow_out, cudaStream_t stream) {
  const IcaLayout L = ica_layout(ts, 0, bm != 0);
  auto kernel = ica_fused_kernel<TS>;
  const cudaError_t err = ica_smem_setup(kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ny * nx, L.lanes, L.smem_bytes, stream>>>(lv, flow_in, terms, nx, ts,
                                                     n_iter, bm, flow_out);
  return (int)cudaGetLastError();
}

extern "C" int hmsr_ica_fused(const float* ref, const float* gx,
                              const float* gy, int ref_w, const float* mov,
                              int h, int w, const float* flow_in,
                              const float* terms, int ny, int nx, int ts,
                              int n_iter, int bm, float* flow_out,
                              void* stream) {
  if (ts < 1 || n_iter < 0) return (int)cudaErrorInvalidValue;
  if (ny <= 0 || nx <= 0) return (int)cudaGetLastError();
  const IcaLevel lv = ica_level(ref, gx, gy, ref_w, mov, h, w);
  const cudaStream_t s = (cudaStream_t)stream;
  bm = bm ? 1 : 0;
#define ICA_ARGS lv, flow_in, terms, ny, nx, ts, n_iter, bm, flow_out, s
#define ICA_CASE(TS_) \
  if (ts == TS_) return launch_fused<TS_>(ICA_ARGS);
  ICA_FIXED_TS(ICA_CASE)
  return launch_fused<0>(ICA_ARGS);
#undef ICA_CASE
#undef ICA_ARGS
}
