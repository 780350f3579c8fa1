// K6: the burst-and-reference fused merge. The F compared frames and then
// the reference frame are merged into (num, den) per HR tile, and the
// accumulators are written once, never read.
//
// Replaces hmsr_tpu/models/merge_slab.py:merge_burst_slab and
// hmsr_tpu/models/merge_fused.py:merge_burst_tiled up to their
// normalization (one_row / one_tile: the fori_loop over the frames, then the
// reference frame's taps, num = vals + rval). The JAX package runs both as
// XLA; neither reaches pl.pallas_call. Four variants, merge_fused_kernel<G,
// ISO> (G = 2 Bayer, 1 grey; ISO = 1 the isotropic kernel); the
// accumulated-robustness denoiser of the reference merge is a run-time
// argument (acc_rob non-null).
//
// Semantics: the accumulators at the padded geometry (c, nty*B, ntx*B), B =
// Ts*s, every padded row and column computed as the slab computes it (a
// negative flow reaches frame samples from rows past the image); first the
// frames in order, each with exactly K5's contribution (merge_stage +
// merge_pixel, common.cuh), summed from zero (acc = acc + vals_f); then the
// reference frame's (merge_ref_stage + merge_ref_pixel, common.cuh), num =
// vals + rval, or rval where the denoiser overwrites. That is F K5 launches
// into zeros followed by the plain reference merge.
//
// Bound on the H100: bytes, each frame's inputs once (raw frame and
// robustness, 8 bytes per raw pixel; covariances, 12 bytes per grey pixel),
// the reference's, and num/den written once (24 bytes per HR pixel): about
// 0.95 ms for 19 frames of 3000x4000 x2. In instructions, K5''s issue rate
// (~0.65 ms per frame) sets ~12 ms. The scan path spends 19 K5 launches,
// each a read-modify-write of the accumulators, and a plain-torch reference
// merge of ~2,000 launches on the same work.
//
// Design: K5''s block layout (one block per HR tile or band of one,
// MERGE_PPT pixels per thread, common.cuh:merge_layout) and its
// double-buffered cp.async frame loop, with the sums in registers from
// zero. After the last frame the block stages the reference window (raw
// rows rint(R/s) +- rr, the covariance rows the bilinear lookup reaches)
// into the first buffer, adds the reference taps from registers and stores
// num/den once.
#include "common.cuh"

template <int G, int ISO>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_fused_kernel(const float* __restrict__ comp, int F, int H, int W,
                       const float* __restrict__ flow, int fny, int fnx,
                       const float* __restrict__ covs, int gh, int gw,
                       const float* __restrict__ rob,
                       const float* __restrict__ ref,
                       const float* __restrict__ rcovs,
                       const float* __restrict__ acc_rob,
                       float* __restrict__ num, float* __restrict__ den,
                       int out_h, int out_w, int Ts, int s, MergeCfa cfa,
                       int cfa_packed, int rows, int bands, int buf_floats,
                       int rr, int rad_max, float max_mult, float max_count) {
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
      n[k][ch] = 0.0f;
      d[k][ch] = 0.0f;
    }
  }

  if (F > 0) {
    merge_stage<G, ISO>(smem, comp, H, W, merge_flow(flow, fnx, ty, tx), covs,
                        gh, gw, rob, ty, tx, r0, rows, Ts, s);
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
      merge_stage_wait();  // every thread is done with both buffers
    }
  }

  merge_ref_stage<G, ISO>(smem, ref, H, W, rcovs, gh, gw, ty, tx, r0, nr, rows,
                          Ts, s, rr);
  merge_stage_wait();
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    if (pr[k] >= 0) {
      float vals[NCH], accs[NCH];
      bool overwrite;
      merge_ref_pixel<G, ISO>(smem, rows, Ts, s, pr[k], pc[k], H, W,
                              cfa_packed, rr, acc_rob, rad_max, max_mult,
                              max_count, vals, accs, overwrite);
      for (int ch = 0; ch < NCH; ++ch) {
        num[ch * plane + po[k]] = overwrite ? vals[ch] : n[k][ch] + vals[ch];
        den[ch * plane + po[k]] = overwrite ? accs[ch] : d[k][ch] + accs[ch];
      }
    }
  }
}

// The launch of hmsr_merge_fused, one instantiation per variant.
struct MergeFusedLaunch {
  const float* comp;
  int F, H, W;
  const float* flow;
  int fny, fnx;
  const float* covs;
  int gh, gw;
  const float* rob;
  const float* ref;
  const float* rcovs;
  const float* acc_rob;
  float* num;
  float* den;
  int out_h, out_w, Ts, s, cfa, rad_max;
  float max_mult, max_count;
  cudaStream_t stream;

  template <int G, int ISO>
  int run() {
    if (Ts < 2 || Ts % 2 != 0 || s < 1) return (int)cudaErrorInvalidValue;
    const MergeLayout L = merge_layout<G, ISO>(Ts, s, F);
    if (acc_rob != nullptr && rad_max < 1) return (int)cudaErrorInvalidValue;
    const int rr = acc_rob != nullptr ? rad_max : 1;
    const int frame_floats = F > 0 ? (F > 1 ? 2 : 1) * L.buf_floats : 0;
    const int ref_floats = merge_ref_floats<G, ISO>(Ts, s, L.rows, rr);
    const int smem_bytes =
        4 * (frame_floats > ref_floats ? frame_floats : ref_floats);
    if (smem_bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          merge_fused_kernel<G, ISO>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (e != cudaSuccess) return (int)e;
    }
    const int B = Ts * s;
    const dim3 grid(out_w / B, out_h / B * L.bands);
    merge_fused_kernel<G, ISO><<<grid, MERGE_THREADS, smem_bytes, stream>>>(
        comp, F, H, W, flow, fny, fnx, covs, gh, gw, rob, ref, rcovs, acc_rob,
        num, den, out_h, out_w, Ts, s, merge_cfa_masks(cfa), cfa, L.rows,
        L.bands, L.buf_floats, rr, rad_max, max_mult, max_count);
    return (int)cudaGetLastError();
  }
};

// comp, rob (F, H, W); flow (F, fny, fnx, 2); covs (F, 3, gh, gw) and the
// reference's rcovs (3, gh, gw) (unread with iso); ref (H, W); acc_rob (H,
// W) or null (no denoiser); num, den (c, out_h, out_w) with out_h, out_w
// whole multiples of Ts*s, written, not read. cfa, grey and iso as for
// hmsr_merge.
extern "C" int hmsr_merge_fused(const float* comp, int F, int H, int W,
                                const float* flow, int fny, int fnx,
                                const float* covs, int gh, int gw,
                                const float* rob, const float* ref,
                                const float* rcovs, const float* acc_rob,
                                float* num, float* den, int out_h, int out_w,
                                int Ts, int s, int cfa, int grey, int iso,
                                int rad_max, float max_mult, float max_count,
                                void* stream) {
  if (F < 0 || out_h <= 0 || out_w <= 0 || Ts * s <= 0 || out_h % (Ts * s) ||
      out_w % (Ts * s)) {
    return (int)cudaErrorInvalidValue;
  }
  MergeFusedLaunch launch{comp, F,       H,        W,         flow,  fny,
                          fnx,  covs,    gh,       gw,        rob,   ref,
                          rcovs, acc_rob, num,     den,       out_h, out_w,
                          Ts,   s,       cfa,      rad_max,   max_mult,
                          max_count, (cudaStream_t)stream};
  return merge_dispatch(grey, iso, launch);
}
