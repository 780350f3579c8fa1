// K4: robustness upscale-warp — Dodgson 3x3 biquadratic sampling of the
// guide-grid 3x3 local statistics at the flow-shifted raw coordinate, plus
// the validity mask.
//
// Replaces hmsr_tpu/ops/pallas_warp.py:_warp_kernel (+ _dogson), launched by
// _warp_impl through upscale_warp_pallas. Semantics of
// hmsr_tpu/models/robustness.py:upscale_warp_stats_tiled, per raw pixel:
//   - the flow is constant per Ts x Ts tile; the centre row is
//     (Sy + 1) + (y_loc + ph_y) // u with Sy = floor_div(ty*Ts + floor(fy +
//     0.5), u) - 1 (explicit floor division: Sy is negative at the border);
//   - tap values come from the tile window at the CLIPPED origin Syc, read
//     edge-clamped; tap weights use the unclipped, clamped centre;
//   - a tile whose window origin had to be clipped is invalid as a whole
//     (ok_tile), whatever the per-pixel bounds say.
//
// Bound on the H100: device memory. At Ts=16, x2 a launch reads the
// (3, 1500, 2000) stats once and writes (3, 3000, 4000) floats and the
// (3000, 4000) mask: 192 MB, 0.057 ms at 3.35 TB/s. The arithmetic, ~140
// instructions per pixel, needs ~0.05 ms at the issue rate.
//
// What held the first design back (one thread per pixel, ~0.53 ms): every
// thread redid the tile's bookkeeping (flow loads, floor, floor division,
// the clipped origin) and runtime divisions by Ts and u, evaluated the
// Dodgson weight of x nine times where three differ, indexed its channel
// sums by a runtime channel count (local memory), fetched each stats value
// ~36 times through L1, and stored scalars.
//
// This design: a block of 256 threads owns a strip of tiles of one tile row
// (warp_layout). The tile-uniform values are computed once per tile. The
// separable parts become a table entry per tile row and per tile column
// (the three clamped Dodgson weights, the window index q of the centre, the
// axis' validity, ok_tile folded into the rows). The stats window at the
// clipped origin, the rows and columns its taps reach, is copied once into
// shared memory with cp.async from edge-clamped addresses. The channel count
// is a template parameter, so the sums live in registers, and so are the
// main path's Ts and u (every index then a constant). A thread owns 4
// consecutive pixels of a tile row and stores them as one float4 per plane
// and the mask as one 32-bit word (a ragged edge stores scalars). Every
// float is computed with the operations, in the order, of the per-pixel
// form (upscale_warp_plain): the weight wy[i] * wx[j], the taps in (i, j)
// order, and lr = (Y + f + 0.5) / u - 0.5 as a true division; the outputs
// are bit-identical to it.
#include "common.cuh"

constexpr int WARP_THREADS = 256;
constexpr int WARP_PPT = 4;       // pixels per thread: one float4 per plane

// The tile-uniform values of one tile of the strip.
struct WarpTile {
  float fx, fy;
  int Sy, Sx, phy, phx, Syc, Sxc, ok, live;
};

// Launch layout: `tiles` tiles of one tile row per block; the staged window
// is sw x sw per channel (the window rows and columns that the taps reach:
// centre indices q = 0 .. (Ts + u - 2) / u, taps q .. q + 2).
struct WarpLayout {
  int tiles, sw, smem_bytes;
};

__host__ __device__ constexpr WarpLayout warp_layout(int Ts, int u, int c) {
  WarpLayout L{};
  const int groups = (Ts + WARP_PPT - 1) / WARP_PPT * Ts;  // per tile
  const int t = WARP_THREADS / groups;
  L.tiles = t < 1 ? 1 : (t > 16 ? 16 : t);
  L.sw = (Ts + u - 2) / u + 3;
  L.smem_bytes = L.tiles * (2 * Ts * 16 + 4 * c * L.sw * L.sw +
                            (int)sizeof(WarpTile));
  return L;
}

// TS == 0: Ts and u at run time (TS, U: the main path's, so that every
// index and shared-memory offset is a constant).
template <int C, int TS, int U>
__global__ void __launch_bounds__(WARP_THREADS)
    warp_kernel(const float* __restrict__ stats, int lh, int lw,
                const float* __restrict__ flow, int fnx, int Ts_rt, int u_rt,
                int H, int W, float* __restrict__ out,
                unsigned char* __restrict__ valid) {
  const int Ts = TS > 0 ? TS : Ts_rt;
  const int u = TS > 0 ? U : u_rt;
  const WarpLayout L = warp_layout(Ts, u, C);
  const int T = L.tiles;
  const int sw = L.sw;
  extern __shared__ float4 sm4[];
  float4* rowt = sm4;                 // T * Ts row entries
  float4* colt = rowt + T * Ts;       // T * Ts column entries
  float* win = reinterpret_cast<float*>(colt + T * Ts);  // [T][C][sw][sw]
  WarpTile* tl = reinterpret_cast<WarpTile*>(win + T * C * sw * sw);
  const int ty = blockIdx.y;
  const int tx0 = blockIdx.x * T;
  const int ntx = (W + Ts - 1) / Ts;
  const int win_floats = C * sw * sw;
  const size_t plane = (size_t)lh * lw;

  // ---- the tile-uniform values, once per tile
  if (threadIdx.x < T) {
    const int tx = tx0 + threadIdx.x;
    WarpTile w = {};
    w.live = tx < ntx;
    if (w.live) {
      const int WIN = Ts / u + 4;
      const int PAD = WIN + 1;
      w.fx = flow[2 * (ty * fnx + tx)];
      w.fy = flow[2 * (ty * fnx + tx) + 1];
      const int base_y = ty * Ts + (int)floorf(w.fy + 0.5f);
      w.Sy = floordiv(base_y, u) - 1;
      w.phy = base_y - u * (w.Sy + 1);
      const int base_x = tx * Ts + (int)floorf(w.fx + 0.5f);
      w.Sx = floordiv(base_x, u) - 1;
      w.phx = base_x - u * (w.Sx + 1);
      w.Syc = clampi(w.Sy, -PAD, lh + PAD - WIN);
      w.Sxc = clampi(w.Sx, -PAD, lw + PAD - WIN);
      w.ok = (w.Syc == w.Sy) && (w.Sxc == w.Sx);
    }
    tl[threadIdx.x] = w;
  }
  __syncthreads();

  // ---- the window of each tile at its clipped origin, edge-clamped:
  // win[t][k][a][b] = stats[k][clamp(Syc + a)][clamp(Sxc + b)]. Sixteen
  // rows of sixteen lanes; the row index (t, k, a) advances without
  // division.
  {
    const int b0 = threadIdx.x & 15;
    int row = threadIdx.x >> 4;
    int t = row / (C * sw);
    int k = (row - t * C * sw) / sw;
    int a = row - (t * C + k) * sw;
    for (; row < T * C * sw; row += 16) {
      if (tl[t].live) {
        const float* src =
            stats + k * plane + (size_t)clampi(tl[t].Syc + a, 0, lh - 1) * lw;
        float* dst = win + row * sw;
        for (int b = b0; b < sw; b += 16) {
          cp_async_f32(dst + b, src + clampi(tl[t].Sxc + b, 0, lw - 1), 4);
        }
      }
      a += 16;
      while (a >= sw) {
        a -= sw;
        if (++k == C) {
          k = 0;
          ++t;
        }
      }
    }
  }

  // ---- a table entry per tile row and per tile column: the Dodgson
  // weights of the three clamped centres, and 2 q + (axis valid)
  for (int e = threadIdx.x; e < 2 * T * Ts; e += WARP_THREADS) {
    const bool is_row = e < T * Ts;
    const int idx = is_row ? e : e - T * Ts;
    const int t = idx / Ts;
    const int l = idx - t * Ts;
    const WarpTile w = tl[t];
    if (!w.live) continue;
    const float f = is_row ? w.fy : w.fx;
    const int n = is_row ? lh : lw;
    const int S = is_row ? w.Sy : w.Sx;
    const int P = (is_row ? ty : tx0 + t) * Ts + l;  // raw row or column
    const int q = (l + (is_row ? w.phy : w.phx)) / u;  // non-negative
    const int center = S + 1 + q;
    const float lr = ((float)P + f + 0.5f) / (float)u - 0.5f;
    const bool ok = lr >= 0.0f && lr < (float)n && (!is_row || w.ok);
    float4 ent;
    ent.x = dogson((float)clampi(center - 1, 0, n - 1) - lr);
    ent.y = dogson((float)clampi(center, 0, n - 1) - lr);
    ent.z = dogson((float)clampi(center + 1, 0, n - 1) - lr);
    ent.w = __int_as_float(2 * q + (ok ? 1 : 0));
    (is_row ? rowt : colt)[idx] = ent;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- pixels: group g is tile row r, tile t, columns c0 .. c0+3
  const int gpr = (Ts + WARP_PPT - 1) / WARP_PPT;
  const int tpr = T * gpr;
  const size_t oplane = (size_t)H * W;
  const bool vec = (W % WARP_PPT) == 0 && (Ts % WARP_PPT) == 0;
  for (int g = threadIdx.x; g < Ts * tpr; g += WARP_THREADS) {
    const int r = g / tpr;
    const int rem = g - r * tpr;
    const int t = rem / gpr;
    const int c0 = (rem - t * gpr) * WARP_PPT;
    const int Y = ty * Ts + r;
    const int X0 = (tx0 + t) * Ts + c0;
    if (Y >= H || X0 >= W) continue;
    const float4 ey = rowt[t * Ts + r];
    const int qy = __float_as_int(ey.w) >> 1;
    const bool oky = __float_as_int(ey.w) & 1;
    const float wy[3] = {ey.x, ey.y, ey.z};
    const float* wt = win + t * win_floats + qy * sw;
    float res[WARP_PPT][C];
    unsigned mask = 0;
#pragma unroll
    for (int p = 0; p < WARP_PPT; ++p) {
      // a column past the tile (Ts not a multiple of 4) repeats the last
      // one and is not stored
      const float4 ex = colt[t * Ts + min(c0 + p, Ts - 1)];
      const int qx = __float_as_int(ex.w) >> 1;
      const float wx[3] = {ex.x, ex.y, ex.z};
      float acc[C];
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] = 0.0f;
      float w_acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float* wr = wt + i * sw + qx;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float wgt = wy[i] * wx[j];
#pragma unroll
          for (int k = 0; k < C; ++k) acc[k] += wr[k * sw * sw + j] * wgt;
          w_acc += wgt;
        }
      }
#pragma unroll
      for (int k = 0; k < C; ++k) res[p][k] = acc[k] / w_acc;
      if (oky && (__float_as_int(ex.w) & 1)) mask |= 1u << (8 * p);
    }
    const size_t o = (size_t)Y * W + X0;
    if (vec && X0 + WARP_PPT <= W) {
#pragma unroll
      for (int k = 0; k < C; ++k) {
        *reinterpret_cast<float4*>(out + k * oplane + o) =
            make_float4(res[0][k], res[1][k], res[2][k], res[3][k]);
      }
      *reinterpret_cast<unsigned*>(valid + o) = mask;
    } else {
#pragma unroll
      for (int p = 0; p < WARP_PPT; ++p) {
        if (c0 + p < Ts && X0 + p < W) {
#pragma unroll
          for (int k = 0; k < C; ++k) out[k * oplane + o + p] = res[p][k];
          valid[o + p] = (mask >> (8 * p)) & 1;
        }
      }
    }
  }
}

template <int C, int TS, int U>
static int launch_warp(const float* stats, int lh, int lw, const float* flow,
                       int fnx, int Ts, int u, int H, int W, float* out,
                       unsigned char* valid, cudaStream_t stream) {
  const WarpLayout L = warp_layout(Ts, u, C);
  auto kernel = warp_kernel<C, TS, U>;
  if (L.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int ntx = (W + Ts - 1) / Ts;
  dim3 grid((ntx + L.tiles - 1) / L.tiles, (H + Ts - 1) / Ts);
  if (H > 0 && W > 0) {
    kernel<<<grid, WARP_THREADS, L.smem_bytes, stream>>>(
        stats, lh, lw, flow, fnx, Ts, u, H, W, out, valid);
  }
  return (int)cudaGetLastError();
}

// (Ts, u, c) with an instantiation of its own: the main paths' (x2, three
// channels, Ts = 16, 32, 64).
static bool warp_fixed(int Ts, int u, int c) {
  return c == 3 && u == 2 && (Ts == 16 || Ts == 32 || Ts == 64);
}

extern "C" int hmsr_upscale_warp(const float* stats, int c, int lh, int lw,
                                 const float* flow, int fnx, int Ts, int u,
                                 int H, int W, float* out,
                                 unsigned char* valid, void* stream) {
  if (Ts < 1 || u < 1 || Ts % u != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define WARP_ARGS stats, lh, lw, flow, fnx, Ts, u, H, W, out, valid, s
  if (warp_fixed(Ts, u, c)) {
    if (Ts == 16) return launch_warp<3, 16, 2>(WARP_ARGS);
    if (Ts == 32) return launch_warp<3, 32, 2>(WARP_ARGS);
    return launch_warp<3, 64, 2>(WARP_ARGS);
  }
  switch (c) {
    case 1: return launch_warp<1, 0, 0>(WARP_ARGS);
    case 2: return launch_warp<2, 0, 0>(WARP_ARGS);
    case 3: return launch_warp<3, 0, 0>(WARP_ARGS);
    case 4: return launch_warp<4, 0, 0>(WARP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WARP_ARGS
}

// The launch layout of (Ts, u, c): out[0] tiles per block, out[1] threads,
// out[2] the staged window's side, out[3] dynamic shared memory bytes,
// out[4] 1 when (Ts, u, c) has an instantiation of its own.
extern "C" int hmsr_warp_layout(int Ts, int u, int c, int* out) {
  if (Ts < 1 || u < 1 || c < 1 || c > 4) return (int)cudaErrorInvalidValue;
  const WarpLayout L = warp_layout(Ts, u, c);
  out[0] = L.tiles;
  out[1] = WARP_THREADS;
  out[2] = L.sw;
  out[3] = L.smem_bytes;
  out[4] = warp_fixed(Ts, u, c) ? 1 : 0;
  return 0;
}
