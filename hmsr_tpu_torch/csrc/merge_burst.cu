// K5': burst-fused merge accumulation of F non-reference frames (Alg. 4) into
// (num, den), the accumulators read and written once per launch.
//
// Replaces hmsr_tpu/ops/pallas_merge.py:_merge_group_kernel as launched by
// merge_burst_pallas (frames grid, F > 1; through _merge_frames_pallas and
// its pallas_call), in the four variants of K5 (merge_burst_kernel<G, ISO>:
// Bayer or grey mode, steerable or isotropic kernel). Semantics: F
// sequential K5 launches of the same variant, bit for bit. Each
// frame's contribution is merge_stage + merge_pixel (common.cuh), the
// functions K5 calls, and it is added to the running sums in frame order
// (acc = acc + vals_f), the additions K5 makes to num/den in memory.
//
// Bound on the H100. In bytes, the accumulators once per launch (48 bytes per
// HR pixel) plus each frame's inputs (raw frame and robustness, 8 bytes per
// raw pixel; covariances, 12 bytes per grey pixel): 0.885 ms for 5 frames of
// 3000x4000 x2. In instructions, the per-pixel work of a frame (~450, 9
// IEEE expf and one IEEE division among them) needs ~0.65 ms per frame at
// the card's issue rate, so K5' is issue-bound and stays far from its byte
// bound. The earlier one-thread-per-pixel form re-derived every tile-, row-
// and column-uniform value per pixel and frame: 13 ms per 5 frames.
//
// Design: K5's block layout and staging (merge.cu); the thread keeps its
// MERGE_PPT x 2 x merge_planes(G) sums in registers across the frames.
// Frame f+1's tables are written and its windows copied with cp.async into
// the second of two shared-memory buffers while frame f is computed from
// the first (the flow of frame f+2 is loaded meanwhile), so the copies
// overlap the arithmetic and one barrier per frame separates the buffers.
#include "common.cuh"

template <int G, int ISO>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_burst_kernel(const float* __restrict__ comp, int F, int H, int W,
                       const float* __restrict__ flow, int fny, int fnx,
                       const float* __restrict__ covs, int gh, int gw,
                       const float* __restrict__ rob, float* __restrict__ num,
                       float* __restrict__ den, int out_h, int out_w, int Ts,
                       int s, MergeCfa cfa, int rows, int bands,
                       int buf_floats) {
  constexpr int NCH = merge_planes(G);
  extern __shared__ __align__(16) float smem[];
  const int B = Ts * s;
  const int tx = blockIdx.x;
  const int ty = blockIdx.y / bands;
  const int r0 = (blockIdx.y - ty * bands) * rows;
  const int nr = min(rows, B - r0);
  const size_t plane = (size_t)out_h * out_w;
  const size_t raw_frame = (size_t)H * W;
  const size_t flow_frame = (size_t)fny * fnx * 2;
  const size_t cov_frame = (size_t)3 * gh * gw;

  int pr[MERGE_PPT], pc[MERGE_PPT];
  size_t po[MERGE_PPT];
  float n[MERGE_PPT][NCH], d[MERGE_PPT][NCH];
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    merge_thread_pixel(k, B, nr, ty * B + r0, tx * B, out_h, out_w, pr[k],
                       pc[k], po[k]);
    for (int ch = 0; ch < NCH; ++ch) {
      n[k][ch] = pr[k] >= 0 ? num[ch * plane + po[k]] : 0.0f;
      d[k][ch] = pr[k] >= 0 ? den[ch * plane + po[k]] : 0.0f;
    }
  }

  // the flow of the frame after the one being staged is loaded one frame
  // ahead, so that staging never waits for it
  merge_stage<G, ISO>(smem, comp, H, W, merge_flow(flow, fnx, ty, tx), covs, gh,
                      gw, rob, ty, tx, r0, rows, Ts, s);
  float2 fl_next = merge_flow(flow + (F > 1 ? flow_frame : 0), fnx, ty, tx);
  merge_stage_wait();
  for (int f = 0; f < F; ++f) {
    const float* cur = smem + (f & 1) * buf_floats;
    if (f + 1 < F) {
      merge_stage<G, ISO>(smem + ((f + 1) & 1) * buf_floats,
                          comp + (f + 1) * raw_frame, H, W, fl_next,
                          covs + (f + 1) * cov_frame, gh, gw,
                          rob + (f + 1) * raw_frame, ty, tx, r0, rows, Ts, s);
      if (f + 2 < F) {
        fl_next = merge_flow(flow + (f + 2) * flow_frame, fnx, ty, tx);
      }
    }
#pragma unroll
    for (int k = 0; k < MERGE_PPT; ++k) {
      if (pr[k] >= 0) {
        float vals[NCH], accs[NCH];
        merge_pixel<G, ISO>(cur, rows, Ts, s, pr[k], pc[k], cfa, vals, accs);
        for (int ch = 0; ch < NCH; ++ch) {
          n[k][ch] = n[k][ch] + vals[ch];
          d[k][ch] = d[k][ch] + accs[ch];
        }
      }
    }
    merge_stage_wait();
  }
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    if (pr[k] >= 0) {
      for (int ch = 0; ch < NCH; ++ch) {
        num[ch * plane + po[k]] = n[k][ch];
        den[ch * plane + po[k]] = d[k][ch];
      }
    }
  }
}

// The launch of hmsr_merge_burst, one instantiation per variant.
struct MergeBurstLaunch {
  const float* comp;
  int F, H, W;
  const float* flow;
  int fny, fnx;
  const float* covs;
  int gh, gw;
  const float* rob;
  float* num;
  float* den;
  int out_h, out_w, Ts, s, cfa;
  cudaStream_t stream;

  template <int G, int ISO>
  int run() {
    MergeLayout L;
    const cudaError_t e =
        merge_launch_setup<G, ISO>(merge_burst_kernel<G, ISO>, Ts, s, F, L);
    if (e != cudaSuccess) return (int)e;
    const int B = Ts * s;
    const dim3 grid((out_w + B - 1) / B, (out_h + B - 1) / B * L.bands);
    merge_burst_kernel<G, ISO><<<grid, MERGE_THREADS, L.smem_bytes, stream>>>(
        comp, F, H, W, flow, fny, fnx, covs, gh, gw, rob, num, den, out_h,
        out_w, Ts, s, merge_cfa_masks(cfa), L.rows, L.bands, L.buf_floats);
    return (int)cudaGetLastError();
  }
};

// cfa, grey and iso as for hmsr_merge; two staging buffers when F > 1.
extern "C" int hmsr_merge_burst(const float* comp, int F, int H, int W,
                                const float* flow, int fny, int fnx,
                                const float* covs, int gh, int gw,
                                const float* rob, float* num, float* den,
                                int out_h, int out_w, int Ts, int s, int cfa,
                                int grey, int iso, void* stream) {
  if (F <= 0 || out_h <= 0 || out_w <= 0) return (int)cudaGetLastError();
  MergeBurstLaunch launch{comp, F,   H,     W,     flow, fny, fnx,
                          covs, gh,  gw,    rob,   num,  den, out_h,
                          out_w, Ts, s,     cfa,   (cudaStream_t)stream};
  return merge_dispatch(grey, iso, launch);
}
