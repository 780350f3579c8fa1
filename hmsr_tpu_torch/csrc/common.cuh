// Shared device helpers of the hmsr_tpu_torch kernels.
#pragma once
#include <cuda_runtime.h>

// Floor division and floor modulo: C++ '/' and '%' truncate toward zero,
// but window origins (Sy, Sx) and CFA parities of negative rows need the
// floor semantics of jnp.floor_divide / jnp '%'.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  int m = a % b;
  return (m != 0 && ((m < 0) != (b < 0))) ? m + b : m;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// Block matching (K1, and the L1 prologue of K3)
// ---------------------------------------------------------------------------

// Stages the sw x sw search window at (top, left) of the moving level and
// the ts x ts reference tile (element (y, x) at rt[y * rs_y + x * rs_x]) in
// shared memory. metric 0 (L1) reads 0 out of bounds, metric 1 (L2) clamps
// coordinates to the level.
__device__ __forceinline__ void bm_stage(float* win, float* reft,
                                         const float* __restrict__ rt,
                                         int rs_y, int rs_x,
                                         const float* __restrict__ mov, int h,
                                         int w, int top, int left, int sw,
                                         int ts, int metric) {
  for (int p = threadIdx.x; p < sw * sw; p += blockDim.x) {
    const int yy = top + p / sw;
    const int xx = left + p % sw;
    float v;
    if (metric == 1) {
      v = mov[(size_t)clampi(yy, 0, h - 1) * w + clampi(xx, 0, w - 1)];
    } else {
      v = (yy >= 0 && yy < h && xx >= 0 && xx < w) ? mov[(size_t)yy * w + xx]
                                                   : 0.0f;
    }
    win[p] = v;
  }
  for (int p = threadIdx.x; p < ts * ts; p += blockDim.x) {
    reft[p] = rt[(size_t)(p / ts) * rs_y + (size_t)(p % ts) * rs_x];
  }
}

// Cost of the candidate (sy, sx) of a staged window, summed over the tile
// in row-major order with __fadd_rn/__fmul_rn (never contracted into FMA):
// the exact summation order of the plain version (block_match_plain), so
// costs, and argmins, are bit-identical to it.
//   metric 0 (L1): sum |ref - win|;  metric 1 (L2): sum win^2 - 2 sum ref*win.
__device__ __forceinline__ float bm_cost(const float* win, const float* reft,
                                         int sw, int ts, int sy, int sx,
                                         int metric) {
  if (metric == 1) {
    float e1 = 0.0f, e2 = 0.0f;
    for (int y = 0; y < ts; ++y) {
      const float* wr = win + (sy + y) * sw + sx;
      const float* rr = reft + y * ts;
      for (int x = 0; x < ts; ++x) {
        const float v = wr[x];
        e1 = __fadd_rn(e1, __fmul_rn(v, v));
        e2 = __fadd_rn(e2, __fmul_rn(rr[x], v));
      }
    }
    return __fsub_rn(e1, __fmul_rn(2.0f, e2));
  }
  float e = 0.0f;
  for (int y = 0; y < ts; ++y) {
    const float* wr = win + (sy + y) * sw + sx;
    const float* rr = reft + y * ts;
    for (int x = 0; x < ts; ++x) {
      e = __fadd_rn(e, fabsf(__fsub_rn(rr[x], wr[x])));
    }
  }
  return e;
}

// Index of the first minimum, as torch.argmin / jnp.argmin pick it.
__device__ __forceinline__ int first_min(const float* cost, int nc) {
  int best = 0;
  float best_e = cost[0];
  for (int c = 1; c < nc; ++c) {
    if (cost[c] < best_e) {
      best_e = cost[c];
      best = c;
    }
  }
  return best;
}

// 4-byte asynchronous copy from global to shared memory; src_bytes 0 writes
// a zero and reads nothing.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// ---------------------------------------------------------------------------
// ICA Gauss-Newton steps (K2, and the steps of K3 after its search)
// ---------------------------------------------------------------------------
//
// Semantics of hmsr_tpu/models/ica.py:refine_ica_tiled, per tile and step:
// the flow (ax, ay) splits by truncation toward zero (negative flows give
// negative fractions); the bilinear taps come from the (ts+1)^2 window of
// the moving level at the tile's origin + trunc(flow), zero outside the
// level (zero taps still contribute gradt = -ref); b = sum -grad * (interp -
// ref) over the tile; then the 2x2 solve with the tile's terms (det_inv,
// a00, a01, a10, a11, from the Hessian once per burst), the flow kept as it
// is where det_inv == 0 (|det| < 1e-10).
//
// A tile is worked by `lanes` threads (ica_layout), about ICA_PIXELS_PER_LANE
// pixels each: one warp up to ts = 16, 4 at ts = 32, 16 at ts = 64. IcaTile
// holds the lane's pixels of ref, gx and gy and the five terms in registers
// for all steps (loaded once); each step stages the window in shared memory
// (zero outside the level, so no tap is bounds-tested), sums the lane's
// pixels in a fixed order, reduces the tile with xor-shuffles (every lane
// gets the same bits: float addition commutes) and, on tiles of several
// warps, adds the warp sums in warp order through shared memory. Every lane
// then solves for itself, so the new flow needs no broadcast. Each pixel
// keeps the operations, in their order, of the plain version
// (ica_step_plain + gn_update); only the order of the pixel sums differs.
// K2 and K3 run this code with the same lanes per tile, so their flows are
// bit-identical.

constexpr int ICA_PIXELS_PER_LANE = 8;
constexpr int ICA_MAX_LANES = 512;
// K2 packs tiles into blocks of this many threads (at least one tile).
constexpr int ICA_K2_THREADS = 256;

// Launch layout of tile size ts: `lanes` threads per tile (a multiple of
// 32), `tiles` tiles per block (K2: block_threads / lanes; K3, which passes
// 0: one), and per tile `tile_floats` of dynamic shared memory: `stage`
// staged floats (the (ts+1)^2 window; with the search of K3 its (ts+2)^2
// window, the ts^2 reference tile and 9 costs, which the Gauss-Newton window
// then overwrites) and 2 per warp for the warp sums.
struct IcaLayout {
  int lanes, tiles, stage, tile_floats, smem_bytes;
};

__host__ __device__ constexpr IcaLayout ica_layout(int ts, int block_threads,
                                                   bool bm) {
  IcaLayout L{};
  const int want = (ts * ts + ICA_PIXELS_PER_LANE - 1) / ICA_PIXELS_PER_LANE;
  const int lanes = (want + 31) / 32 * 32;
  L.lanes = lanes < ICA_MAX_LANES ? lanes : ICA_MAX_LANES;
  L.tiles = block_threads / L.lanes > 1 ? block_threads / L.lanes : 1;
  const int win = (ts + 1) * (ts + 1);
  const int search = (ts + 2) * (ts + 2) + ts * ts + 9;
  L.stage = bm && search > win ? search : win;
  L.tile_floats = L.stage + 2 * (L.lanes / 32);
  L.smem_bytes = 4 * L.tiles * L.tile_floats;
  return L;
}

// The level a launch works on: the reference level and its gradients (same
// shape, row stride ref_w) and the moving level (h, w). `align`: the
// largest of 4, 2, 1 floats to which the three reference pointers and ref_w
// are aligned (vector loads of the tile need it).
struct IcaLevel {
  const float* ref;
  const float* gx;
  const float* gy;
  int ref_w, align;
  const float* mov;
  int h, w;
};

// Synchronises the threads of a tile: its warp, or the block (whose tiles
// all run the same steps) for tiles of several warps.
__device__ __forceinline__ void ica_tile_sync(int warps) {
  if (warps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The tile's sum of (s0, s1) in every lane: xor-shuffles in the warp, then
// the warp sums in warp order (red: 2 floats per warp).
__device__ __forceinline__ float2 ica_tile_sum(float s0, float s1, float* red,
                                               int g, int warps) {
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (warps == 1) return make_float2(s0, s1);
  if ((g & 31) == 0) {
    red[2 * (g >> 5)] = s0;
    red[2 * (g >> 5) + 1] = s1;
  }
  __syncthreads();
  float b0 = red[0], b1 = red[1];
  for (int i = 1; i < warps; ++i) {
    b0 += red[2 * i];
    b1 += red[2 * i + 1];
  }
  return make_float2(b0, b1);
}

// Stages the n x n window of the moving level at (top, left) into win (row
// stride n) with cp.async, zero outside the level; the tile's `lanes` lanes
// share it (N: n at compile time, 0 at run time). On an H100 cp.async was
// faster than plain loads and stores (K2 at Ts = 16: 0.127 against 0.135 ms
// a frame, PERF.md section 6).
template <int N>
__device__ __forceinline__ void ica_stage(float* win, const IcaLevel& lv,
                                          int top, int left, int n_rt, int g,
                                          int lanes) {
  const int n = N > 0 ? N : n_rt;
  for (int e = g; e < n * n; e += lanes) {
    const int a = e / n;
    const int yy = top + a;
    const int xx = left + e - a * n;
    const bool in = (unsigned)yy < (unsigned)lv.h && (unsigned)xx < (unsigned)lv.w;
    cp_async_f32(win + e, lv.mov + (in ? (size_t)yy * lv.w + xx : 0), in ? 4 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loads CW consecutive floats, as one vector where `align` allows.
template <int CW>
__device__ __forceinline__ void ica_load(const float* __restrict__ p,
                                         int align, float* out) {
  if constexpr (CW == 4) {
    if (align >= 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      out[0] = v.x;
      out[1] = v.y;
      out[2] = v.z;
      out[3] = v.w;
      return;
    }
  } else if constexpr (CW == 2) {
    if (align >= 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p));
      out[0] = v.x;
      out[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < CW; ++k) out[k] = __ldg(p + k);
}

// One tile of the Gauss-Newton steps, seen from lane g. TS: the tile size
// at compile time, or 0 for one at run time. With TS, the lane owns NCH
// consecutive rows of CW consecutive pixels (rows NCH * (g / CPR) ..., from
// column CW * (g % CPR)), loaded as vectors; its taps come from NCH + 1
// window rows, and each window row's horizontal lerp serves as the bottom
// of one pixel row and the top of the next (the same operations, so the same
// bits). With ts at run time, the lane takes pixels g, g + lanes, ... in
// row-major order and reads ref, gx and gy from global memory each step.
template <int TS>
struct IcaTile {
  static constexpr int LANES = TS > 0 ? ica_layout(TS, 0, false).lanes : 0;
  static constexpr int PPL = TS > 0 ? TS * TS / LANES : 1;
  static constexpr int CW = PPL < 4 ? PPL : 4;
  static constexpr int NCH = PPL / CW;
  static constexpr int CPR = TS > 0 ? TS / CW : 1;
  static_assert(TS == 0 || (PPL * LANES == TS * TS && NCH * CW == PPL &&
                            CPR * CW == TS),
                "tile size without a lane layout");

  int ts, lanes, ty, tx, g, row0, col;
  float t[5];
  float r[NCH][CW], x[NCH][CW], y[NCH][CW];

  // Reads the terms (5 floats) and, with TS, the lane's reference pixels.
  __device__ __forceinline__ void load(const IcaLevel& lv, int ts_rt, int ty_,
                                       int tx_, int g_,
                                       const float* __restrict__ terms) {
    ts = TS > 0 ? TS : ts_rt;
    lanes = TS > 0 ? LANES : ica_layout(ts_rt, 0, false).lanes;
    ty = ty_;
    tx = tx_;
    g = g_;
#pragma unroll
    for (int i = 0; i < 5; ++i) t[i] = terms[i];
    if constexpr (TS > 0) {
      row0 = NCH * (g / CPR);
      col = (g % CPR) * CW;
      const size_t base = (size_t)(ty * TS + row0) * lv.ref_w + tx * TS + col;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const size_t o = base + (size_t)j * lv.ref_w;
        ica_load<CW>(lv.ref + o, lv.align, r[j]);
        ica_load<CW>(lv.gx + o, lv.align, x[j]);
        ica_load<CW>(lv.gy + o, lv.align, y[j]);
      }
    }
  }

  // The lane's share of b at flow fraction (fx, fy) from the staged window.
  __device__ __forceinline__ float2 partial(const IcaLevel& lv,
                                            const float* win, float fx,
                                            float fy) const {
    float s0 = 0.0f, s1 = 0.0f;
    if constexpr (TS > 0) {
      constexpr int W = TS + 1;
      float prev[CW];
#pragma unroll
      for (int j = 0; j <= NCH; ++j) {
        const float* wr = win + (row0 + j) * W + col;
        float cur[CW];
#pragma unroll
        for (int k = 0; k < CW; ++k) {
          const float m0 = wr[k];
          const float m1 = wr[k + 1];
          cur[k] = m0 + (m1 - m0) * fx;
        }
        if (j > 0) {
#pragma unroll
          for (int k = 0; k < CW; ++k) {
            const float interp = prev[k] + (cur[k] - prev[k]) * fy;
            const float gradt = interp - r[j - 1][k];
            s0 += -x[j - 1][k] * gradt;
            s1 += -y[j - 1][k] * gradt;
          }
        }
#pragma unroll
        for (int k = 0; k < CW; ++k) prev[k] = cur[k];
      }
    } else {
      const int W = ts + 1;
      const size_t rbase = (size_t)ty * ts * lv.ref_w + (size_t)tx * ts;
      int py = g / ts;
      int px = g - py * ts;
      for (int p = g; p < ts * ts; p += lanes) {
        const float* wr = win + py * W + px;
        const float m00 = wr[0];
        const float m01 = wr[1];
        const float m10 = wr[W];
        const float m11 = wr[W + 1];
        const float top = m00 + (m01 - m00) * fx;
        const float bot = m10 + (m11 - m10) * fx;
        const float interp = top + (bot - top) * fy;
        const size_t ri = rbase + (size_t)py * lv.ref_w + px;
        const float gradt = interp - __ldg(lv.ref + ri);
        s0 += -__ldg(lv.gx + ri) * gradt;
        s1 += -__ldg(lv.gy + ri) * gradt;
        px += lanes;
        while (px >= ts) {
          px -= ts;
          ++py;
        }
      }
    }
    return make_float2(s0, s1);
  }

  // n_iter steps from flow fl; every lane of the tile returns the same
  // flow. win: the tile's staged floats, red: its 2 per warp.
  __device__ __forceinline__ float2 steps(const IcaLevel& lv, float2 fl,
                                          int n_iter, float* win,
                                          float* red) const {
    const int n = TS > 0 ? TS : ts;
    const int nl = TS > 0 ? LANES : lanes;
    const int warps = nl >> 5;
    for (int it = 0; it < n_iter; ++it) {
      const float ix = truncf(fl.x);
      const float iy = truncf(fl.y);
      const float fx = fl.x - ix;
      const float fy = fl.y - iy;
      // the previous step's reads of the window are done (tiles of several
      // warps passed the barrier of ica_tile_sum since)
      if (warps == 1) __syncwarp();
      ica_stage<(TS > 0 ? TS + 1 : 0)>(win, lv, ty * n + (int)iy,
                                       tx * n + (int)ix, n + 1, g, nl);
      ica_tile_sync(warps);
      const float2 p = partial(lv, win, fx, fy);
      const float2 b = ica_tile_sum(p.x, p.y, red, g, warps);
      if (t[0] != 0.0f) {
        const float dx = t[0] * (t[4] * b.x - t[2] * b.y);
        const float dy = t[0] * (-t[3] * b.x + t[1] * b.y);
        fl.x = fl.x + dx;
        fl.y = fl.y + dy;
      }
    }
    return fl;
  }
};

// IcaLevel of the C entry points.
inline IcaLevel ica_level(const float* ref, const float* gx, const float* gy,
                          int ref_w, const float* mov, int h, int w) {
  const unsigned long long bits = (unsigned long long)ref |
                                  (unsigned long long)gx |
                                  (unsigned long long)gy;
  int align = 1;
  if (bits % 16 == 0 && ref_w % 4 == 0) {
    align = 4;
  } else if (bits % 8 == 0 && ref_w % 2 == 0) {
    align = 2;
  }
  return IcaLevel{ref, gx, gy, ref_w, align, mov, h, w};
}

// Tile sizes with instantiations of their own in K2 and K3 (the levels of
// the main paths at Ts = 16, 32, 64); any other runs the TS = 0 kernel.
#define ICA_FIXED_TS(X) X(8) X(16) X(32) X(64)

inline bool ica_fixed(int ts) {
#define ICA_IS(TS_) || ts == TS_
  return false ICA_FIXED_TS(ICA_IS);
#undef ICA_IS
}

// Raises the dynamic shared-memory limit of `kernel` to `bytes` when they
// exceed the 48 KB default; the card refuses what is beyond its own limit.
template <typename Kernel>
inline cudaError_t ica_smem_setup(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}


// ---------------------------------------------------------------------------
// Merge accumulation (K5, and every frame of K5')
// ---------------------------------------------------------------------------
//
// Semantics of hmsr_tpu/models/merge_tiled.py:merge_tiled (integer scale s),
// for HR pixel (R, C) of a non-reference frame, in four variants: G = 2
// (Bayer) or G = 1 (grey mode), times the steerable (ISO = 0) or the
// isotropic (ISO = 1) kernel:
//   - the flow is constant per (Ts*s)^2 HR tile; the 3x3 raw neighbourhood is
//     centred at (Sy + 1) + (r_loc + ph_y) // s with Sy = floor_div(ty*B +
//     floor(0.5 + s*fy), s) - 1; values come from the tile window at the
//     CLIPPED origin Syc (zero outside the frame), and a clipped tile is
//     invalid as a whole (ok_tile);
//   - steerable: the covariance is bilinearly interpolated at lr_mov/G - 0.5
//     on the covariance grid (the grey grid of half the raw size for Bayer,
//     the raw grid in grey mode) from the window at the clipped origin
//     S2yc; index -1 holds the linear extrapolation 2 c[0] - c[1] (per axis,
//     rows first), beyond it edge values; the 2x2 inverse is unguarded and
//     z = max(0, d^T Omega^-1 d);
//   - iso: z = max(0, 2 (dx^2 + dy^2)), no covariance is read;
//   - w = exp(-z/2) * r;
//   - Bayer: the CFA channel comes from the floor parity of the sample's raw
//     row and column (three accumulator planes); grey: one plane.
//
// A merge block owns `rows` HR rows of one HR tile (all of it at Ts=16, x2).
// merge_stage() writes one frame's share of the tile into a shared-memory
// buffer: the tile-uniform values once, a table entry per HR row and per HR
// column (what the pixel derives from its row or column alone), and the
// raw, covariance (steerable only) and robustness windows, the covariance
// padding resolved. merge_pixel() is then what truly varies per pixel.
// Every float is computed with the operations, in the order, of
// merge_plain's per-pixel form, so the staging changes no bit of the
// result.

constexpr int MERGE_THREADS = 256;
// HR pixels per thread. On an H100, 1 was the slowest for both kernels
// (four blocks stage the same tile at Ts=16, x2), 2 and 4 level for K5,
// 4 the fastest for K5'.
constexpr int MERGE_PPT = 4;

// Accumulator planes of a variant: three CFA channels (Bayer) or one.
__host__ __device__ constexpr int merge_planes(int G) { return G == 2 ? 3 : 1; }

// What a pixel takes from its HR row (or column) r_loc of the tile.
struct __align__(16) MergeAxis {
  int q;          // 3x3 taps at raw window row (column) q + 1 + d, d = -1..1
  int q2;         // covariance cell at window row (column) q2, q2 + 1
                  // (steerable only)
  int rob;        // index in the staged robustness window; -1 when the
                  // centre is outside the frame (rows: or the tile clipped)
  int par;        // floor parity of the centre's raw row (column) (Bayer)
  float frac;     // covariance bilinear fraction (steerable only)
  float dist[3];  // tap coordinate minus the moved centre, per d
  float in[3];    // 1 where tap d lies in the frame, else 0
  float pad_;
};

// Staged window sizes of a block of `rows` HR rows: the raw window is Ts+3
// columns wide and the covariance windows Ts/G+2 (none for ISO); their
// rows, and the robustness rows, are those the block's HR rows reach.
struct MergeWindows {
  int RW, RWr, CW, CWr, RR;
};

template <int G, int ISO>
__host__ __device__ inline MergeWindows merge_windows(int Ts, int s,
                                                      int rows) {
  MergeWindows w;
  w.RW = Ts + 3;
  const int raw_rows = (rows - 1 + s - 1) / s + 3;
  w.RWr = raw_rows < w.RW ? raw_rows : w.RW;
  w.CW = 0;
  w.CWr = 0;
  if (!ISO) {
    const int sg = G * s;
    const int cov_rows = (rows - 1 + sg - 1) / sg + 2;
    w.CW = Ts / G + 2;
    w.CWr = cov_rows < w.CW ? cov_rows : w.CW;
  }
  w.RR = (rows - 1 + s - 1) / s + 1;
  return w;
}

// Floats of one staged frame: the row and column tables and the windows,
// rounded up to 16 bytes.
template <int G, int ISO>
__host__ __device__ inline int merge_buffer_floats(int Ts, int s, int rows) {
  const MergeWindows w = merge_windows<G, ISO>(Ts, s, rows);
  const int n = 12 * (rows + Ts * s) + w.RWr * w.RW + 3 * w.CWr * w.CW +
                w.RR * Ts;
  return (n + 3) / 4 * 4;
}

// Launch layout of K5 (F = 1) and of K5' over F frames: a block covers
// `rows` HR rows of one (Ts*s)^2 HR tile, at most MERGE_THREADS * MERGE_PPT
// pixels, in `bands` blocks per tile; its dynamic shared memory holds one
// staged frame of `buf_floats` floats, two when K5' has more than one frame.
struct MergeLayout {
  int rows, bands, buf_floats, smem_bytes;
};

template <int G, int ISO>
inline MergeLayout merge_layout(int Ts, int s, int F) {
  const int B = Ts * s;
  const int fit = MERGE_THREADS * MERGE_PPT / B;
  MergeLayout L;
  L.rows = fit < 1 ? 1 : (fit > B ? B : fit);
  L.bands = (B + L.rows - 1) / L.rows;
  L.buf_floats = merge_buffer_floats<G, ISO>(Ts, s, L.rows);
  L.smem_bytes = (F > 1 ? 2 : 1) * 4 * L.buf_floats;
  return L;
}

// Row (or column) r_loc of tile t along an axis of n raw pixels: f is the
// tile's flow, S/ph and S2/ph2 the raw and covariance window origins and
// phases, qbase/q2base the first staged raw and covariance window rows
// (columns: 0) and rbase the first staged robustness row (column).
template <int G, int ISO>
__device__ __forceinline__ MergeAxis merge_axis(int r_loc, int t, int Ts, int s,
                                                int n, float f, int S, int ph,
                                                int S2, int ph2, int qbase,
                                                int q2base, int rbase,
                                                bool ok) {
  const int B = Ts * s;
  const float sf = (float)s;
  const int R = t * B + r_loc;
  MergeAxis a;
  const int q = (r_loc + ph) / s;  // non-negative operands
  const int center = S + 1 + q;
  const float lr = ((float)R + 0.5f) / sf;
  const float lr_mov = lr + f;
  a.q = q - qbase;
  a.q2 = 0;
  a.frac = 0.0f;
  if (!ISO) {
    const int q2 = (r_loc + ph2) / (s * G);
    a.frac = (lr_mov / (float)G - 0.5f) - (float)(S2 + 1 + q2);
    a.q2 = q2 - q2base;
  }
  const float dist_ref = lr_mov - 0.5f;
  a.par = G == 2 ? floormod(center, 2) : 0;
  for (int d = -1; d <= 1; ++d) {
    const int i_g = center + d;
    a.in[d + 1] = (i_g >= 0 && i_g < n) ? 1.0f : 0.0f;
    a.dist[d + 1] = (float)i_g - dist_ref;
  }
  a.pad_ = 0.0f;
  a.rob = (lr_mov >= 0.0f && lr_mov < (float)n && ok)
              ? min(R / s, n - 1) - rbase : -1;
  return a;
}

// covs_pad semantics of merge_tiled: edge padding, and the linear
// extrapolation at index -1 along rows, then along columns.
__device__ __forceinline__ float cov_row(const float* __restrict__ cv, int gh,
                                         int gw, int i, int j) {
  const int jj = clampi(j, 0, gw - 1);
  if (i == -1) {
    return 2.0f * cv[jj] - cv[(size_t)clampi(1, 0, gh - 1) * gw + jj];
  }
  return cv[(size_t)clampi(i, 0, gh - 1) * gw + jj];
}

__device__ __forceinline__ float cov_at(const float* __restrict__ cv, int gh,
                                        int gw, int i, int j) {
  if (j == -1) {
    return 2.0f * cov_row(cv, gh, gw, i, 0) -
           cov_row(cv, gh, gw, i, clampi(1, 0, gw - 1));
  }
  return cov_row(cv, gh, gw, i, j);
}

// The CFA channel of each 3x3 tap, for the four floor parities (pi, pj) of
// the centre's raw row and column: m[2 pi + pj] has bit 9 ch + t set when
// tap t = 3 (di + 1) + (dj + 1) falls in channel ch. Built on the host from
// the 2x2 pattern cfa packed as cfa00 | cfa01 << 2 | cfa10 << 4 | cfa11 << 6.
// Bayer only; grey mode passes it unread.
struct MergeCfa {
  int m[4];
};

inline MergeCfa merge_cfa_masks(int cfa) {
  MergeCfa c;
  for (int pq = 0; pq < 4; ++pq) {
    int m = 0;
    for (int t = 0; t < 9; ++t) {
      const int pi = ((pq >> 1) + t / 3 - 1) & 1;
      const int pj = ((pq & 1) + t % 3 - 1) & 1;
      m |= 1 << (9 * ((cfa >> (2 * (2 * pi + pj))) & 3) + t);
    }
    c.m[pq] = m;
  }
  return c;
}

// The flow (x, y) of tile (ty, tx).
__device__ __forceinline__ float2 merge_flow(const float* __restrict__ flow,
                                             int fnx, int ty, int tx) {
  return make_float2(flow[2 * (ty * fnx + tx)], flow[2 * (ty * fnx + tx) + 1]);
}

// Stages one frame's share of HR tile (ty, tx) at flow fl, HR rows r0 ..
// r0+rows-1 of the tile, into buf (merge_buffer_floats<G, ISO>(Ts, s, rows)
// floats). All threads of the block take part. The tables are written
// directly; the windows are copied with cp.async (zero-filled outside the
// frame), except the covariance entries at index -1, which are extrapolated
// here (border tiles only). merge_stage_wait() completes the copies for the
// block.
template <int G, int ISO>
__device__ __forceinline__ void merge_stage(
    float* buf, const float* __restrict__ comp, int H, int W, float2 fl,
    const float* __restrict__ covs, int gh, int gw,
    const float* __restrict__ rob, int ty, int tx, int r0, int rows, int Ts,
    int s) {
  const int B = Ts * s;
  const int sg = s * G;
  const float sf = (float)s;
  const float fx = fl.x;
  const float fy = fl.y;

  // ---- tile-uniform values: window origins, clipped origins, phases
  const int WIN = Ts + 4;
  const int PAD = WIN + 1;
  const int base_y = ty * B + (int)floorf(__fadd_rn(0.5f, __fmul_rn(sf, fy)));
  const int Sy = floordiv(base_y, s) - 1;
  const int ph_y = base_y - s * (Sy + 1);
  const int base_x = tx * B + (int)floorf(__fadd_rn(0.5f, __fmul_rn(sf, fx)));
  const int Sx = floordiv(base_x, s) - 1;
  const int ph_x = base_x - s * (Sx + 1);
  const int Syc = clampi(Sy, -PAD, H + PAD - WIN);
  const int Sxc = clampi(Sx, -PAD, W + PAD - WIN);
  const bool ok_tile = (Syc == Sy) && (Sxc == Sx);
  int S2y = 0, ph2_y = 0, S2x = 0, ph2_x = 0, S2yc = 0, S2xc = 0;
  if (!ISO) {
    const int CWIN = Ts / G + 4;
    const int CPAD = CWIN + 1;
    const float halfsg = 0.5f * (float)sg;
    const int base2_y = ty * B + (int)floorf(__fsub_rn(
                                     __fadd_rn(0.5f, __fmul_rn(sf, fy)), halfsg));
    S2y = floordiv(base2_y, sg) - 1;
    ph2_y = base2_y - sg * (S2y + 1);
    const int base2_x = tx * B + (int)floorf(__fsub_rn(
                                     __fadd_rn(0.5f, __fmul_rn(sf, fx)), halfsg));
    S2x = floordiv(base2_x, sg) - 1;
    ph2_x = base2_x - sg * (S2x + 1);
    S2yc = clampi(S2y, -CPAD, gh + CPAD - CWIN);
    S2xc = clampi(S2x, -CPAD, gw + CPAD - CWIN);
  }
  const int rbase_y = min(ty * Ts + r0 / s, H - 1);
  const int rbase_x = min(tx * Ts, W - 1);

  const MergeWindows w = merge_windows<G, ISO>(Ts, s, rows);
  const int qbase = (r0 + ph_y) / s;
  const int q2base = ISO ? 0 : (r0 + ph2_y) / sg;
  MergeAxis* rowt = reinterpret_cast<MergeAxis*>(buf);
  MergeAxis* colt = rowt + rows;
  float* raw = reinterpret_cast<float*>(colt + B);
  float* cov = raw + w.RWr * w.RW;
  float* rb = cov + 3 * w.CWr * w.CW;
  const int nr = min(rows, B - r0);
  for (int i = threadIdx.x; i < nr + B; i += blockDim.x) {
    if (i < nr) {
      rowt[i] = merge_axis<G, ISO>(r0 + i, ty, Ts, s, H, fy, Sy, ph_y, S2y,
                                   ph2_y, qbase, q2base, rbase_y, ok_tile);
    } else {
      colt[i - nr] = merge_axis<G, ISO>(i - nr, tx, Ts, s, W, fx, Sx, ph_x,
                                        S2x, ph2_x, 0, 0, rbase_x, true);
    }
  }
  // the raw window at the clipped origin, from the band's first row; zero
  // outside the frame
  const int RW = w.RW;
  for (int p = threadIdx.x; p < w.RWr * RW; p += blockDim.x) {
    const int y = Syc + qbase + p / RW;
    const int x = Sxc + p % RW;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    cp_async_f32(raw + p, in ? comp + (size_t)y * W + x : comp, in ? 4 : 0);
  }
  // covariance windows from row S2yc+1 (+ the band's first) and column
  // S2xc+1, padding resolved: cov_at is the edge-clamped entry, except at
  // index -1
  if (!ISO) {
    const int CW = w.CW, CWr = w.CWr;
    for (int p = threadIdx.x; p < 3 * CWr * CW; p += blockDim.x) {
      const int k = p / (CWr * CW);
      const int e = p - k * CWr * CW;
      const int i = S2yc + 1 + q2base + e / CW;
      const int j = S2xc + 1 + e % CW;
      const float* cv = covs + (size_t)k * gh * gw;
      if (i == -1 || j == -1) {
        cov[p] = cov_at(cv, gh, gw, i, j);
      } else {
        cp_async_f32(cov + p,
                     cv + (size_t)clampi(i, 0, gh - 1) * gw + clampi(j, 0, gw - 1),
                     4);
      }
    }
  }
  for (int p = threadIdx.x; p < w.RR * Ts; p += blockDim.x) {
    const int y = min(rbase_y + p / Ts, H - 1);
    const int x = min(rbase_x + p % Ts, W - 1);
    cp_async_f32(rb + p, rob + (size_t)y * W + x, 4);
  }
}

// Completes this thread's copies of merge_stage, then the block's.
__device__ __forceinline__ void merge_stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// One frame's contribution at row r (of the staged rows) and column c of
// the tile: the kernel-weighted sum of its 3x3 raw taps per accumulator
// plane (vals, merge_planes(G) of them) and the sum of the weights (accs),
// in the tap order of merge_plain. K5 adds the result to num/den once per
// launch, K5' once per frame of its chunk: both call merge_stage and this
// function, so F K5 launches equal one K5' launch bit for bit.
template <int G, int ISO>
__device__ __forceinline__ void merge_pixel(const float* buf, int rows, int Ts,
                                            int s, int r, int c,
                                            const MergeCfa& cfa, float* vals,
                                            float* accs) {
  constexpr int NCH = merge_planes(G);
  const int B = Ts * s;
  const MergeWindows w = merge_windows<G, ISO>(Ts, s, rows);
  const int RW = w.RW, CW = w.CW;
  const MergeAxis* rowt = reinterpret_cast<const MergeAxis*>(buf);
  const MergeAxis* colt = rowt + rows;
  const float* raw = reinterpret_cast<const float*>(colt + B);
  const float* cov = raw + w.RWr * RW;
  const float* rb = cov + 3 * w.CWr * CW;
  const MergeAxis ay = rowt[r];
  const MergeAxis ax = colt[c];

  // ---- steerable: covariance interpolation and inverse
  float ixx = 0.0f, ixy = 0.0f, iyy = 0.0f;
  if (!ISO) {
    const float* cw = cov + ay.q2 * CW + ax.q2;
    float cc[3];
    for (int k = 0; k < 3; ++k) {
      const float* ck = cw + k * w.CWr * CW;
      const float c00 = ck[0];
      const float c01 = ck[1];
      const float c10 = ck[CW];
      const float c11 = ck[CW + 1];
      const float top = c00 + ax.frac * (c01 - c00);
      const float bot = c10 + ax.frac * (c11 - c10);
      cc[k] = top + ay.frac * (bot - top);
    }
    const float det = cc[0] * cc[2] - cc[1] * cc[1];
    const float inv_det = 1.0f / det;
    ixx = inv_det * cc[2];
    ixy = -inv_det * cc[1];
    iyy = inv_det * cc[0];
  }

  // ---- 3x3 accumulation. The weight's in-frame factor is the product of
  // the row's and the column's 0/1 (exactly (inb ? 1 : 0)). Bayer adds each
  // tap to its CFA channel only, as a predicated add (no branch).
  const float wr = (ay.rob >= 0 && ax.rob >= 0) ? rb[ay.rob * Ts + ax.rob]
                                                : 0.0f;
  int m = 0;
  if (G == 2) {
    const int pq = 2 * ay.par + ax.par;
    m = pq == 0 ? cfa.m[0]
                : (pq == 1 ? cfa.m[1] : (pq == 2 ? cfa.m[2] : cfa.m[3]));
  }
  for (int k = 0; k < NCH; ++k) {
    vals[k] = 0.0f;
    accs[k] = 0.0f;
  }
  for (int di = -1; di <= 1; ++di) {
    const float dist_y = ay.dist[di + 1];
    const float* rr = raw + (ay.q + 1 + di) * RW + ax.q + 1;
    for (int dj = -1; dj <= 1; ++dj) {
      const int t = 3 * (di + 1) + (dj + 1);
      const float dist_x = ax.dist[dj + 1];
      const float cval = rr[dj];
      float z;
      if (ISO) {
        z = 2.0f * (dist_x * dist_x + dist_y * dist_y);
      } else {
        z = ixx * dist_x * dist_x + 2.0f * ixy * dist_x * dist_y +
            iyy * dist_y * dist_y;
      }
      z = fmaxf(z, 0.0f);
      const float wgt =
          expf(-0.5f * z) * wr * (ay.in[di + 1] * ax.in[dj + 1]);
      const float wc = wgt * cval;
      if (G == 2) {
        for (int k = 0; k < NCH; ++k) {
          if ((m >> (9 * k + t)) & 1) {
            vals[k] += wc;
            accs[k] += wgt;
          }
        }
      } else {
        vals[0] += wc;
        accs[0] += wgt;
      }
    }
  }
}

// Pixel k of this thread in a merge block: p = threadIdx.x + k *
// MERGE_THREADS is HR row r = p / B (of the block's nr rows, from HR row R0)
// and column c = p % B of the tile (from HR column C0), so neighbouring
// threads take neighbouring columns. r is -1 for a pixel outside the band
// or the image; o is the pixel's offset in an accumulator plane.
__device__ __forceinline__ void merge_thread_pixel(int k, int B, int nr, int R0,
                                                   int C0, int out_h, int out_w,
                                                   int& r, int& c, size_t& o) {
  const int p = threadIdx.x + k * MERGE_THREADS;
  r = p / B;
  c = p - r * B;
  const int R = R0 + r;
  const int C = C0 + c;
  o = (size_t)R * out_w + C;
  if (!(r < nr && R < out_h && C < out_w)) r = -1;
}

// Launch checks shared by the K5 and K5' entry points: sets L to the layout
// of (Ts, s, F) and raises the dynamic shared-memory limit of `kernel` when
// its bytes exceed the 48 KB default, which the card refuses beyond its own
// limit. Returns a cudaError_t.
template <int G, int ISO, typename Kernel>
inline cudaError_t merge_launch_setup(Kernel kernel, int Ts, int s, int F,
                                      MergeLayout& L) {
  if (Ts < 2 || Ts % 2 != 0 || s < 1) return cudaErrorInvalidValue;
  L = merge_layout<G, ISO>(Ts, s, F);
  if (L.smem_bytes > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                L.smem_bytes);
  }
  return cudaSuccess;
}

// The variant of the C entry points' (grey, iso) flags: calls
// fn.template run<G, ISO>() for G = grey ? 1 : 2 and ISO = iso ? 1 : 0.
template <typename Fn>
inline int merge_dispatch(int grey, int iso, Fn& fn) {
  if (grey) {
    return iso ? fn.template run<1, 1>() : fn.template run<1, 0>();
  }
  return iso ? fn.template run<2, 1>() : fn.template run<2, 0>();
}
