// K2: all n_iter Gauss-Newton steps of the ICA (inverse-compositional
// Lucas-Kanade) refinement of a level's tiles in one launch, solve
// included; returns the new flow.
//
// Replaces hmsr_tpu/ops/pallas_ica.py:_ica_step_kernel (launched by
// _ica_step_run through ica_step_pallas, once per step by _gn_iterations,
// with the 2x2 solve between launches). The JAX package splits a level of
// 2000 tiles or more into one launch per step for a TPU reason: short kernel
// bodies pipeline across its sequential grid, one long serial body does
// not. On the H100 thousands of resident warps hide one tile's serial chain
// of steps, so a launch runs all steps, as the JAX package's fused form
// (HMSR_ICA_FUSED=1, K3's kernel) does on any level. Semantics: the steps of
// hmsr_tpu/models/ica.py:refine_ica_tiled (common.cuh, IcaTile).
//
// Bound on the H100: device memory. All steps of a level read ref, gx, gy
// and the moving level once (4 x 48 MB at the finest level of a 12 MP frame,
// 0.057 ms at 3.35 TB/s) plus 7 floats a tile; the arithmetic, ~14
// operations a pixel and step, is far below the card's flop/byte balance.
//
// What held the one-step design back (one block of 256 threads per tile,
// one pixel a thread, 3 launches a level, ~0.43 ms a frame): every step
// re-read ref, gx and gy (3 of the 4 planes); each pixel made four
// bounds-tested tap loads and a run-time division by ts; each step ended in
// a block reduction with a barrier and a serial sum of 8 warps in thread 0;
// 46,750 blocks a launch at the finest level; and the 2x2 solve ran as ~13
// torch launches between steps.
//
// This design: the steps run in the kernel (IcaTile in common.cuh). A lane
// works 8 pixels of a tile (2 at ts = 8), loaded once as float4 rows (float2
// at ts = 8; scalars on a level whose width is not a multiple of 4) with
// neighbouring lanes on neighbouring addresses, and keeps them, and the
// tile's five terms, in registers for all steps. Each step stages the tile's
// (ts+1)^2 window in shared memory, zero outside the level, from which the
// taps are read untested, sums the lane's pixels, reduces with
// xor-shuffles (tiles of several warps then add their warp sums in order)
// and solves in every lane. Tiles of one warp (ts <= 16) need no block
// barrier. Tiles are packed into blocks of 256 threads (8 tiles at ts = 16:
// 5,844 blocks at the finest level of a 12 MP frame instead of 46,750). The
// main paths' tile sizes are template parameters (loops unrolled, no
// run-time division per pixel); any other runs the same code with ts at run
// time. K3 runs the same steps with the same lanes per tile, so K2 equals K3
// without its search bit for bit. No atomics.
#include "common.cuh"

// TS == 0: ts at run time.
template <int TS>
__global__ void __launch_bounds__(ICA_MAX_LANES)
    ica_steps_kernel(IcaLevel lv, const float* __restrict__ flow_in,
                     const float* __restrict__ terms, int ny, int nx,
                     int ts_rt, int n_iter, float* __restrict__ flow_out) {
  const IcaLayout L = ica_layout(TS > 0 ? TS : ts_rt, ICA_K2_THREADS, false);
  extern __shared__ float sm[];
  const int tl = threadIdx.x / L.lanes;
  const int g = threadIdx.x - tl * L.lanes;
  const int n_tiles = ny * nx;
  const int tile_raw = blockIdx.x * L.tiles + tl;
  // a spare tile of the last block repeats the level's last tile: it takes
  // part in the block's barriers and writes nothing
  const int tile = min(tile_raw, n_tiles - 1);
  const int ty = tile / nx;
  const int tx = tile - ty * nx;
  float* win = sm + tl * L.tile_floats;
  IcaTile<TS> t;
  t.load(lv, ts_rt, ty, tx, g, terms + 5 * (size_t)tile);
  const float2 fl = t.steps(lv, make_float2(flow_in[2 * tile], flow_in[2 * tile + 1]),
                            n_iter, win, win + L.stage);
  if (g == 0 && tile_raw < n_tiles) {
    flow_out[2 * tile] = fl.x;
    flow_out[2 * tile + 1] = fl.y;
  }
}

template <int TS>
static int launch_steps(const IcaLevel& lv, const float* flow_in,
                        const float* terms, int ny, int nx, int ts, int n_iter,
                        float* flow_out, cudaStream_t stream) {
  const IcaLayout L = ica_layout(ts, ICA_K2_THREADS, false);
  auto kernel = ica_steps_kernel<TS>;
  const cudaError_t err = ica_smem_setup(kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(ny * nx + L.tiles - 1) / L.tiles, L.tiles * L.lanes, L.smem_bytes,
           stream>>>(lv, flow_in, terms, ny, nx, ts, n_iter, flow_out);
  return (int)cudaGetLastError();
}

// flow_out = n_iter Gauss-Newton steps from flow_in ((ny, nx, 2), x then y)
// with the tiles' terms ((ny, nx, 5)).
extern "C" int hmsr_ica_steps(const float* ref, const float* gx,
                              const float* gy, int ref_w, const float* mov,
                              int h, int w, const float* flow_in,
                              const float* terms, int ny, int nx, int ts,
                              int n_iter, float* flow_out,
                              void* stream) {
  if (ts < 1 || n_iter < 0) return (int)cudaErrorInvalidValue;
  if (ny <= 0 || nx <= 0) return (int)cudaGetLastError();
  const IcaLevel lv = ica_level(ref, gx, gy, ref_w, mov, h, w);
  const cudaStream_t s = (cudaStream_t)stream;
#define ICA_ARGS lv, flow_in, terms, ny, nx, ts, n_iter, flow_out, s
#define ICA_CASE(TS_) \
  if (ts == TS_) return launch_steps<TS_>(ICA_ARGS);
  ICA_FIXED_TS(ICA_CASE)
  return launch_steps<0>(ICA_ARGS);
#undef ICA_CASE
#undef ICA_ARGS
}

// The launch layout of K2 (k3 = 0) or K3 (k3 = 1, bm: with its search) at
// tile size ts: out[0] 1 for an instantiation of its own, 0 for the
// run-time one; out[1] tiles per block, out[2] threads per tile, out[3]
// threads per block, out[4] dynamic shared memory bytes.
extern "C" int hmsr_ica_layout(int ts, int k3, int bm, int* out) {
  if (ts < 1) return (int)cudaErrorInvalidValue;
  const IcaLayout L = ica_layout(ts, k3 ? 0 : ICA_K2_THREADS, k3 && bm);
  out[0] = ica_fixed(ts) ? 1 : 0;
  out[1] = L.tiles;
  out[2] = L.lanes;
  out[3] = L.tiles * L.lanes;
  out[4] = L.smem_bytes;
  return 0;
}
