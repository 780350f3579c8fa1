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
// frames in order, each with K5's contribution (the same taps, weights and
// windows as merge_pixel, summed in another order and with approximate
// exponentials: merge_fused_pixel, common.cuh); then the reference frame's
// (merge_ref_stage + merge_ref_pixel_fast, or merge_ref_pixel at a tap
// radius above 2), num = vals + rval, or rval where the denoiser overwrites.
// That is F K5 launches into zeros followed by the plain reference merge, to
// rounding (within 1e-6 of the largest value at the main path's shapes).
//
// Bound on the H100: operations, ~142 per HR pixel and frame counted once
// each at 67 TFLOP/s, 2.04 ms for 19 frames of 3000x4000 x2 (bytes: each
// frame's raw frame and robustness, 8 bytes per raw pixel, covariances 12
// per grey pixel, the reference's, and num/den written once, 24 bytes per
// HR pixel: 1.12 ms). Besides, the 9 exponentials per HR pixel and frame
// run on the special-function units, 16 per clock per SM: 8.7 G at the main
// path, 2.1-2.3 ms whatever the design.
//
// Design. The first form of K6 ran merge_pixel, written for K5's
// bit-identity with its plain version (-fmad=false, IEEE expf and division,
// 27 predicated channel adds per pixel): ~600 instructions per HR pixel and
// frame, bound by the instruction rate. This one keeps K5''s block layout
// (one block per HR tile or band of one, MERGE_PPT pixels per thread,
// merge_layout) and:
//   - merge_fused_pixel (common.cuh): ~200 instructions per pixel and frame
//     (shared and pre-scaled exponent terms, ex2.approx, __frcp_rn, class
//     sums per tap parity); the thread keeps 4 parity sums per pixel (Bayer)
//     over the frames and maps them to the CFA channels once;
//   - a ring of three staged frames, frame f+2 copied while frame f is
//     merged, one barrier per frame;
//   - merge_stage<G, ISO, FusedAxis>: divisions through approximate
//     reciprocals, the tables built by the first warps while the others copy
//     the windows, 16-byte copies of the raw, covariance and robustness rows
//     where the rows and pointers are 16-byte aligned (vec);
//   - where B divides the block's threads, a thread's pixels share one
//     column, whose table entry it loads once per frame;
//   - the reference taps through merge_ref_pixel_fast at radius 1 or 2.
// 2 blocks of 256 threads per SM (at most 128 registers): 3 blocks (80
// registers) spilled and ran slower. After the last frame the block stages
// the reference window (raw rows rint(R/s) +- rr, the covariance rows the
// bilinear lookup reaches) into the first buffer, adds the reference taps
// from registers and stores num/den once.
#include "common.cuh"

template <int G, int ISO>
__global__ void __launch_bounds__(MERGE_THREADS, 2)
    merge_fused_kernel(const float* __restrict__ comp, int F, int H, int W,
                       const float* __restrict__ flow, int fny, int fnx,
                       const float* __restrict__ covs, int gh, int gw,
                       const float* __restrict__ rob,
                       const float* __restrict__ ref,
                       const float* __restrict__ rcovs,
                       const float* __restrict__ acc_rob,
                       float* __restrict__ num, float* __restrict__ den,
                       int out_h, int out_w, int Ts, int s, int cfa_packed,
                       int rows, int bands, int buf_floats, int vec, int rr,
                       int rad_max, float max_mult, float max_count) {
  constexpr int NCH = merge_planes(G);
  constexpr int NP = merge_fused_pairs(G);
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
  float nv[MERGE_PPT][NP], na[MERGE_PPT][NP];
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    merge_thread_pixel(k, B, nr, ty * B + r0, tx * B, out_h, out_w, pr[k],
                       pc[k], po[k]);
    for (int q = 0; q < NP; ++q) {
      nv[k][q] = 0.0f;
      na[k][q] = 0.0f;
    }
  }
  // merge_thread_pixel gives pixel k column (threadIdx.x + k MERGE_THREADS)
  // % B: the same for every k where B divides MERGE_THREADS
  const bool one_col = MERGE_THREADS % B == 0;

  if (F > 0) {
    // a ring of three buffers: frame f+2 is staged while frame f is merged
    merge_stage<G, ISO, FusedAxis>(smem, comp, H, W,
                                   merge_flow(flow, fnx, ty, tx), covs, gh, gw,
                                   rob, ty, tx, r0, rows, Ts, s, vec);
    merge_stage_commit();
    float2 fl_next = merge_flow(flow + (F > 2 ? 2 * flow_frame : 0), fnx, ty, tx);
    if (F > 1) {
      merge_stage<G, ISO, FusedAxis>(
          smem + buf_floats, comp + raw_frame, H, W,
          merge_flow(flow + flow_frame, fnx, ty, tx), covs + cov_frame, gh, gw,
          rob + raw_frame, ty, tx, r0, rows, Ts, s, vec);
    }
    merge_stage_commit();
    for (int f = 0; f < F; ++f) {
      merge_stage_wait_prior();  // frame f is staged; frame f-1's buffer free
      if (f + 2 < F) {
        const int g = f + 2;
        merge_stage<G, ISO, FusedAxis>(
            smem + (g % 3) * buf_floats, comp + g * raw_frame, H, W, fl_next,
            covs + g * cov_frame, gh, gw, rob + g * raw_frame, ty, tx, r0, rows,
            Ts, s, vec);
        if (g + 1 < F) fl_next = merge_flow(flow + (g + 1) * flow_frame, fnx, ty, tx);
      }
      merge_stage_commit();
      const float* cur = smem + (f % 3) * buf_floats;
      const FusedAxis* rowt = reinterpret_cast<const FusedAxis*>(cur);
      const FusedAxis* colt = rowt + rows;
      if (one_col) {
        const FusedAxis ax = colt[pc[0]];
#pragma unroll
        for (int k = 0; k < MERGE_PPT; ++k) {
          if (pr[k] >= 0) {
            merge_fused_pixel<G, ISO>(cur, rows, Ts, s, rowt[pr[k]], ax, nv[k],
                                      na[k]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < MERGE_PPT; ++k) {
          if (pr[k] >= 0) {
            merge_fused_pixel<G, ISO>(cur, rows, Ts, s, rowt[pr[k]],
                                      colt[pc[k]], nv[k], na[k]);
          }
        }
      }
    }
    merge_stage_wait();  // the empty groups; every thread is done with frame F-1
  }

  merge_ref_stage<G, ISO>(smem, ref, H, W, rcovs, gh, gw, ty, tx, r0, nr, rows,
                          Ts, s, rr);
  merge_stage_wait();
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    if (pr[k] >= 0) {
      float n[NCH], d[NCH], vals[NCH], accs[NCH];
      bool overwrite;
      merge_fused_channels<G>(nv[k], na[k], cfa_packed, n, d);
      if (rr == 1) {
        merge_ref_pixel_fast<G, ISO, 1>(smem, rows, Ts, s, pr[k], pc[k], H, W,
                                        cfa_packed, acc_rob, rad_max, max_mult,
                                        max_count, vals, accs, overwrite);
      } else if (rr == 2) {
        merge_ref_pixel_fast<G, ISO, 2>(smem, rows, Ts, s, pr[k], pc[k], H, W,
                                        cfa_packed, acc_rob, rad_max, max_mult,
                                        max_count, vals, accs, overwrite);
      } else {
        merge_ref_pixel<G, ISO>(smem, rows, Ts, s, pr[k], pc[k], H, W,
                                cfa_packed, rr, acc_rob, rad_max, max_mult,
                                max_count, vals, accs, overwrite);
      }
      for (int ch = 0; ch < NCH; ++ch) {
        num[ch * plane + po[k]] = overwrite ? vals[ch] : n[ch] + vals[ch];
        den[ch * plane + po[k]] = overwrite ? accs[ch] : d[ch] + accs[ch];
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
    const int buf_floats = merge_fused_buffer_floats<G, ISO>(Ts, s, L.rows);
    const int frame_floats = (F < 3 ? F : 3) * buf_floats;
    // 16-byte copies of the raw, covariance and robustness windows where
    // the rows and pointers are 16-byte aligned
    const auto al16 = [](const void* p) { return ((size_t)p & 15) == 0; };
    const int vec = (W % 4 == 0 && al16(comp) ? 1 : 0) |
                    (gw % 4 == 0 && al16(covs) ? 2 : 0) |
                    (W % 4 == 0 && Ts % 4 == 0 && al16(rob) ? 4 : 0);
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
        num, den, out_h, out_w, Ts, s, cfa, L.rows, L.bands, buf_floats, vec,
        rr, rad_max, max_mult, max_count);
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
