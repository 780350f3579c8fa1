// K5: merge accumulation of one non-reference frame (Alg. 4) into (num, den).
//
// Replaces hmsr_tpu/ops/pallas_merge.py:_merge_group_kernel (launched by
// _merge_frames_pallas through merge_pallas), in all four of its variants:
// Bayer or grey mode, times the steerable or the isotropic kernel, each an
// instantiation merge_kernel<G, ISO> (G = 2 Bayer, 1 grey). The staging and
// the per-pixel arithmetic are merge_stage and merge_pixel in common.cuh,
// shared with K5' (merge_burst.cu).
//
// Bound on the H100: bytes, per HR pixel a read-modify-write of 6
// accumulator floats (48 bytes): 0.73 ms at 3000x4000 x2. The work that
// truly varies per pixel (the covariance interpolation and 2x2 inverse, 9
// quadratic forms with IEEE expf, the accumulation) is ~450 instructions, so
// the issue rate sets a second floor of ~0.65 ms, and the two overlap only
// as far as the SM has warps to switch to. The earlier one-thread-per-
// pixel form also re-derived, per pixel, the tile's flow, window origins,
// clipped origins and phases (a dozen integer divisions by run-time
// values), its row's and column's coordinates (two IEEE divisions) and 12
// edge-clamped covariance gathers: 2.8 ms. Grey mode reads and writes a
// third of the accumulator bytes (one plane) but keeps the per-pixel
// covariance work, so it stays nearer the instruction floor; the isotropic
// kernel drops the covariance window, interpolation and inverse.
//
// Banded accumulators (the branch of pallas_merge.py:merge_pallas with a
// row_offset, lines 290-299 and 382-430, that parallel/sharded.py runs for
// its space axis): num/den may hold a band of `acc_h` HR rows whose first row
// is global row t0*B (B = Ts*s). A block of band tile row ty works on global
// tile row t0 + ty: it stages that row's frame, flow, covariance and
// robustness windows and writes local rows. Tile rows past the image and HR
// rows past the global out_h contribute nothing; t0 = 0 with acc_h = out_h is
// the full accumulator.
//
// Design: one block of MERGE_THREADS threads per HR tile, or per band of
// `rows` HR rows of one (MERGE_PPT pixels per thread; merge_layout in
// common.cuh). Each thread first loads its accumulators (their latency
// overlaps the staging). merge_stage computes the tile-uniform values once
// and a table entry per HR row and per HR column, and copies the raw window
// (zero outside the frame), the covariance windows (the index -1
// extrapolation resolved) and the robustness rows that the band reaches
// into shared memory with cp.async; the pixel loop reads only shared
// memory, has no edge branches, and adds each tap to its CFA channel with
// predicated adds. Each thread owns its num/den entries: no atomics;
// neighbouring threads take neighbouring HR columns, so the accumulator
// traffic is coalesced.
#include "common.cuh"

template <int G, int ISO>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* __restrict__ comp, int H, int W,
                 const float* __restrict__ flow, int fnx,
                 const float* __restrict__ covs, int gh, int gw,
                 const float* __restrict__ rob, float* __restrict__ num,
                 float* __restrict__ den, int out_h, int out_w, int t0,
                 int acc_h, int Ts, int s, MergeCfa cfa, int rows, int bands) {
  constexpr int NCH = merge_planes(G);
  extern __shared__ __align__(16) float smem[];
  const int B = Ts * s;
  const int tx = blockIdx.x;
  const int ty_band = blockIdx.y / bands;
  const int ty = t0 + ty_band;  // the global tile row
  const int r0 = (blockIdx.y - ty_band * bands) * rows;
  const int nr = min(rows, B - r0);
  // the accumulator rows that hold rows of the image
  const int band_h = min(acc_h, out_h - t0 * B);
  const size_t plane = (size_t)acc_h * out_w;
  // the thread's accumulators are loaded first: their latency overlaps
  // the staging
  int pr[MERGE_PPT], pc[MERGE_PPT];
  size_t po[MERGE_PPT];
  float n[MERGE_PPT][NCH], d[MERGE_PPT][NCH];
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    merge_thread_pixel(k, B, nr, ty_band * B + r0, tx * B, band_h, out_w, pr[k],
                       pc[k], po[k]);
    for (int ch = 0; ch < NCH; ++ch) {
      n[k][ch] = pr[k] >= 0 ? num[ch * plane + po[k]] : 0.0f;
      d[k][ch] = pr[k] >= 0 ? den[ch * plane + po[k]] : 0.0f;
    }
  }
  merge_stage<G, ISO>(smem, comp, H, W, merge_flow(flow, fnx, ty, tx), covs, gh,
                      gw, rob, ty, tx, r0, rows, Ts, s);
  merge_stage_wait();
#pragma unroll
  for (int k = 0; k < MERGE_PPT; ++k) {
    if (pr[k] >= 0) {
      float vals[NCH], accs[NCH];
      merge_pixel<G, ISO>(smem, rows, Ts, s, pr[k], pc[k], cfa, vals, accs);
      for (int ch = 0; ch < NCH; ++ch) {
        num[ch * plane + po[k]] = n[k][ch] + vals[ch];
        den[ch * plane + po[k]] = d[k][ch] + accs[ch];
      }
    }
  }
}

// The launch of hmsr_merge, one instantiation per variant.
struct MergeLaunch {
  const float* comp;
  int H, W;
  const float* flow;
  int fnx;
  const float* covs;
  int gh, gw;
  const float* rob;
  float* num;
  float* den;
  int out_h, out_w, t0, acc_h, Ts, s, cfa;
  cudaStream_t stream;

  template <int G, int ISO>
  int run() {
    MergeLayout L;
    const cudaError_t e =
        merge_launch_setup<G, ISO>(merge_kernel<G, ISO>, Ts, s, 1, L);
    if (e != cudaSuccess) return (int)e;
    const int B = Ts * s;
    // the band's tile rows that hold rows of the image
    const int nb = min((acc_h + B - 1) / B, (out_h + B - 1) / B - t0);
    if (nb <= 0) return (int)cudaGetLastError();
    const dim3 grid((out_w + B - 1) / B, nb * L.bands);
    merge_kernel<G, ISO><<<grid, MERGE_THREADS, L.smem_bytes, stream>>>(
        comp, H, W, flow, fnx, covs, gh, gw, rob, num, den, out_h, out_w, t0,
        acc_h, Ts, s, merge_cfa_masks(cfa), L.rows, L.bands);
    return (int)cudaGetLastError();
  }
};

// cfa: the 2x2 pattern packed as in merge_cfa_masks (read in Bayer mode
// only); grey: one accumulator plane and covariances on the raw grid; iso:
// the isotropic kernel (covs unread). out_h is the image's HR height; num
// and den hold acc_h HR rows from global row t0 * Ts * s (t0 = 0, acc_h =
// out_h: the whole image).
extern "C" int hmsr_merge(const float* comp, int H, int W, const float* flow,
                          int fnx, const float* covs, int gh, int gw,
                          const float* rob, float* num, float* den, int out_h,
                          int out_w, int t0, int acc_h, int Ts, int s, int cfa,
                          int grey, int iso, void* stream) {
  if (out_h <= 0 || out_w <= 0 || acc_h <= 0) return (int)cudaGetLastError();
  if (t0 < 0) return (int)cudaErrorInvalidValue;
  MergeLaunch launch{comp, H,   W,     flow,  fnx,   covs, gh, gw,
                     rob,  num, den,   out_h, out_w, t0,   acc_h, Ts,
                     s,    cfa, (cudaStream_t)stream};
  return merge_dispatch(grey, iso, launch);
}

// The layout of one variant.
struct MergeLayoutQuery {
  int Ts, s, F;
  int* out;

  template <int G, int ISO>
  int run() {
    const MergeLayout L = merge_layout<G, ISO>(Ts, s, F);
    out[0] = L.rows;
    out[1] = L.bands;
    out[2] = L.smem_bytes;
    return 0;
  }
};

// The layout hmsr_merge (F = 1) and hmsr_merge_burst use for (Ts, s, F) and
// the variant (grey, iso): out = {HR rows per block, blocks per HR tile,
// dynamic shared memory bytes per block}.
extern "C" int hmsr_merge_layout(int Ts, int s, int F, int grey, int iso,
                                 int* out) {
  if (Ts < 2 || Ts % 2 != 0 || s < 1 || F < 1) return (int)cudaErrorInvalidValue;
  MergeLayoutQuery query{Ts, s, F, out};
  return merge_dispatch(grey, iso, query);
}
