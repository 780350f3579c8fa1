// K10: the robustness map of one compared frame in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA around
// its warp kernel (hmsr_tpu/models/robustness.py:239 compute_robustness,
// pallas_warp.py:_warp_kernel inside), and the port ran it as plain torch
// around K4, about 125 launches a frame, each a full pass over a (3, H, W)
// float32 tensor. Semantics of its plain version
// (ops/cuda_robustness.py:robustness_plain), per pixel of the (H, W) raw grid:
//   - the guide image: Bayer quads with the white balance undone (each phase
//     times the float32 reciprocal of its gain, the two greens added and
//     halved), or the raw frame itself in grey mode;
//   - its 3x3 local mean with clamped edges: the three rows summed in order,
//     then the three column sums in order, times the float32 1/9 (the plain
//     version divides by Python numbers, which PyTorch's CUDA division turns
//     into a multiply by the rounded reciprocal);
//   - K4's Dodgson upscale-warp of the means (csrc/warp.cu: the same tile
//     bookkeeping, clipped window origin, edge clamp, ok_tile rule and order
//     of operations);
//   - d_sq = sum over channels, in channel order, of d^2 s^2, with
//     d = |ref mean - warped mean| and s = d^2 / (d^2 + d_t^2);
//   - S of the tile: s1 where the range of the flow over the 3x3 tile
//     neighbourhood (edge-clamped) exceeds Mt, else s2;
//   - R = clamp(S exp(-d_sq / sigma^2) - t, 0, 1), 0 where the reference's
//     or the warp's validity fails;
//   - the 5x5 local minimum of R with clamped edges.
// Every float is computed with the plain version's operations in its order
// (-fmad=false, IEEE division, expf; a NaN passes the clamp and the minimum as
// in PyTorch), so R is the plain version's on the card.
//
// Bound on the H100: device memory. A 12 MP Bayer frame (3000 x 4000 raw
// pixels) reads the raw frame (48 MB) and the reference's statistics as
// init_robustness lays them out (means 144 MB, d_t 144, sigma^2 48, validity
// 12) and writes R (48 MB): 444 MB, 0.13 ms at 3.35 TB/s.
//
// Design: a block of 256 threads owns a region of whole Ts-tiles, about 32 x
// 64 pixels (rob_layout). The 5x5 minimum needs R two pixels beyond the
// region; those pixels lie in the neighbouring tiles and are warped with
// their own flows. So the block computes R before the minimum on the region
// and a 2-pixel ring around it, into shared memory, from its work tiles: its
// own tiles and the ring of their neighbours. Each work tile stages only the
// part of its window that its pixels reach (a ring tile needs 2 pixel rows:
// 4 window rows): the guide image, converted from the raw frame as it is read
// (the raw window never needs shared memory), then its 3x3 means, into two
// mosaics of per-tile slots whose sizes follow from the geometry alone. The
// tile-uniform values are computed once per work tile, the Dodgson weights
// once per pixel row and tile column and once per pixel column and tile row
// (tables, as in K4). Then R per pixel of the region and ring, its reference
// statistics loaded ahead of the warp's arithmetic (0.48 -> 0.38 ms a frame
// at Ts=16 on the H100 with the separable minimum), then the minimum: of 5
// rows per column, then of 5 columns, 4 pixels a thread, stored as one
// float4. Channels and upscale (Bayer 3 / 2, grey 1 / 1) and the main paths'
// Ts (16, 32, 64) are template parameters; other Ts run an instantiation
// with Ts at run time.
#include "common.cuh"

constexpr int ROB_THREADS = 256;
// the most dynamic shared memory a run-time-Ts layout takes before its
// region is halved
constexpr int ROB_SMEM_MAX = 100 * 1024;

// Window rows (or columns) that n consecutive pixel rows of one tile reach:
// the Dodgson centres (l + ph) / u, and a tap on either side.
__host__ __device__ constexpr int rob_nwin(int n, int u) { return (n + u - 2) / u + 3; }

// The tile-uniform values of one work tile.
struct RobTile {
  float fx, fy, s;
  int Sy, Sx, phy, phx, Syc, Sxc, ok, live;
  int alo, blo;  // first window row / column that the tile's slot holds
  int g0, h0;    // guide row / column (unclamped) of staged row / column 0
  int rs, cs;    // window rows / columns that the tile's pixels reach
};

// A block owns ty x tx tiles; ey x ex pixels are its region and the ring.
// Mosaic slots: hw (ring tile) or iw (own tile) window rows or columns, and
// two more of the guide image each.
struct RobLayout {
  int ty, tx, ey, ex, hw, iw, mr, mc, gr, gc, smem_bytes;
};

__host__ __device__ constexpr RobLayout rob_layout_of(int Ts, int u, int c, int ty,
                                                      int tx) {
  RobLayout L{};
  L.ty = ty;
  L.tx = tx;
  L.ey = ty * Ts + 4;
  L.ex = tx * Ts + 4;
  L.hw = rob_nwin(2, u);
  L.iw = rob_nwin(Ts, u);
  L.mr = 2 * L.hw + ty * L.iw;
  L.mc = 2 * L.hw + tx * L.iw;
  L.gr = L.mr + 2 * (ty + 2);
  L.gc = L.mc + 2 * (tx + 2);
  const int guide = 4 * c * L.gr * L.gc;
  const int rpre = 4 * (L.ey + ty * Ts) * L.ex;  // R, then the minima of 5 rows
  L.smem_bytes = 16 * ((tx + 2) * L.ey + (ty + 2) * L.ex) + 4 * c * L.mr * L.mc +
                 (guide > rpre ? guide : rpre) +
                 (ty + 2) * (tx + 2) * (int)sizeof(RobTile);
  return L;
}

// About 32 x 64 pixels a block; a small Ts whose slots would take more than
// ROB_SMEM_MAX halves the region, the longer side first.
__host__ __device__ constexpr RobLayout rob_layout(int Ts, int u, int c) {
  int ty = Ts >= 32 ? 1 : 32 / Ts;
  int tx = Ts >= 64 ? 1 : 64 / Ts;
  RobLayout L = rob_layout_of(Ts, u, c, ty, tx);
  while (L.smem_bytes > ROB_SMEM_MAX && (ty > 1 || tx > 1)) {
    if (tx >= 2 * ty || ty == 1) {
      tx = (tx + 1) / 2;
    } else {
      ty = (ty + 1) / 2;
    }
    L = rob_layout_of(Ts, u, c, ty, tx);
  }
  return L;
}

// Slot of mosaic row (or column) r: work tile w (0 the ring before the
// region, 1 .. n its own tiles, n + 1 the ring after) and row i in the slot.
__device__ __forceinline__ void rob_slot(int r, int halo, int inner, int n, int& w,
                                         int& i) {
  if (r < halo) {
    w = 0;
    i = r;
    return;
  }
  r -= halo;
  const int k = r / inner;
  w = k < n ? 1 + k : n + 1;
  i = r - (w - 1) * inner;
}

__device__ __forceinline__ int rob_origin(int w, int halo, int inner) {
  return w == 0 ? 0 : halo + (w - 1) * inner;
}

// One table entry of pixel row (or column) P of a work tile starting at t0:
// the Dodgson weights of the three clamped centres, and 2 q + (axis valid)
// with q the centre's row in the tile's slot (K4's arithmetic).
__device__ __forceinline__ float4 rob_axis(int P, int t0, float f, int S, int ph,
                                           int lo, int n, bool ok_tile, int u) {
  const int q = (P - t0 + ph) / u;
  const int center = S + 1 + q;
  const float lr = ((float)P + f + 0.5f) / (float)u - 0.5f;
  const bool ok = lr >= 0.0f && lr < (float)n && ok_tile;
  float4 e;
  e.x = dogson((float)clampi(center - 1, 0, n - 1) - lr);
  e.y = dogson((float)clampi(center, 0, n - 1) - lr);
  e.z = dogson((float)clampi(center + 1, 0, n - 1) - lr);
  e.w = __int_as_float(2 * (q - lo) + (ok ? 1 : 0));
  return e;
}

// torch.minimum: a NaN wins.
__device__ __forceinline__ float rob_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// TS == 0: Ts at run time. C == 3: Bayer (upscale 2), C == 1: grey (1).
template <int C, int TS>
__global__ void __launch_bounds__(ROB_THREADS)
    robustness_kernel(const float* __restrict__ raw, int rw,
                      const float* __restrict__ ref_means,
                      const float* __restrict__ ref_dt,
                      const float* __restrict__ ref_sigma,
                      const unsigned char* __restrict__ ref_valid,
                      const float* __restrict__ flow, int fny, int fnx, int Ts_rt,
                      int H, int W, int cfa, float iwb0, float iwb1, float iwb2,
                      float mth2, float s1, float s2, float thr,
                      float* __restrict__ out) {
  constexpr int U = C == 3 ? 2 : 1;
  const int Ts = TS > 0 ? TS : Ts_rt;
  const RobLayout L = rob_layout(Ts, U, C);
  const int lh = H / U, lw = W / U;
  const int nwx = L.tx + 2;
  const int gplane = L.gr * L.gc, mplane = L.mr * L.mc;
  const int ghw = L.hw + 2, giw = L.iw + 2;
  extern __shared__ float4 rob_sm[];
  float4* rowt = rob_sm;                // [tx + 2][ey]
  float4* colt = rowt + nwx * L.ey;     // [ty + 2][ex]
  float* means = reinterpret_cast<float*>(colt + (L.ty + 2) * L.ex);  // [C][mr][mc]
  float* guide = means + C * mplane;    // [C][gr][gc]; then R before the minimum
  float* rpre = guide;                  // [ey][ex], then the minima of 5 rows
  float* vmin = rpre + L.ey * L.ex;     // [ty Ts][ex]
  const int rmin = (L.ey + L.ty * Ts) * L.ex;
  RobTile* tiles =
      reinterpret_cast<RobTile*>(guide + (C * gplane > rmin ? C * gplane : rmin));
  const int ty0 = blockIdx.y * L.ty, tx0 = blockIdx.x * L.tx;
  const int y0 = ty0 * Ts, x0 = tx0 * Ts;
  const int y1 = min(y0 + L.ty * Ts, H), x1 = min(x0 + L.tx * Ts, W);
  const int ey0 = max(y0 - 2, 0), ey1 = min(y0 + L.ty * Ts + 2, H);
  const int ex0 = max(x0 - 2, 0), ex1 = min(x0 + L.tx * Ts + 2, W);

  // ---- the tile-uniform values, once per work tile
  for (int k = threadIdx.x; k < (L.ty + 2) * nwx; k += blockDim.x) {
    const int ty = ty0 - 1 + k / nwx, tx = tx0 - 1 + k % nwx;
    const int r0 = max(ty * Ts, ey0), r1 = min(ty * Ts + Ts, ey1);
    const int c0 = max(tx * Ts, ex0), c1 = min(tx * Ts + Ts, ex1);
    RobTile w = {};
    w.live = r0 < r1 && c0 < c1;
    if (w.live) {
      const int WIN = Ts / U + 4;
      const int PAD = WIN + 1;
      w.fx = flow[2 * (ty * fnx + tx)];
      w.fy = flow[2 * (ty * fnx + tx) + 1];
      const int base_y = ty * Ts + (int)floorf(w.fy + 0.5f);
      w.Sy = floordiv(base_y, U) - 1;
      w.phy = base_y - U * (w.Sy + 1);
      const int base_x = tx * Ts + (int)floorf(w.fx + 0.5f);
      w.Sx = floordiv(base_x, U) - 1;
      w.phx = base_x - U * (w.Sx + 1);
      w.Syc = clampi(w.Sy, -PAD, lh + PAD - WIN);
      w.Sxc = clampi(w.Sx, -PAD, lw + PAD - WIN);
      w.ok = (w.Syc == w.Sy) && (w.Sxc == w.Sx);
      w.alo = (r0 - ty * Ts + w.phy) / U;
      w.rs = (r1 - 1 - ty * Ts + w.phy) / U + 3 - w.alo;
      w.blo = (c0 - tx * Ts + w.phx) / U;
      w.cs = (c1 - 1 - tx * Ts + w.phx) / U + 3 - w.blo;
      w.g0 = clampi(w.Syc + w.alo, 0, lh - 1) - 1;
      w.h0 = clampi(w.Sxc + w.blo, 0, lw - 1) - 1;
      float hi0 = w.fx, lo0 = w.fx, hi1 = w.fy, lo1 = w.fy;
      for (int i = -1; i <= 1; ++i) {
        for (int j = -1; j <= 1; ++j) {
          const float* f =
              flow + 2 * (clampi(ty + i, 0, fny - 1) * fnx + clampi(tx + j, 0, fnx - 1));
          hi0 = fmaxf(hi0, f[0]);
          lo0 = fminf(lo0, f[0]);
          hi1 = fmaxf(hi1, f[1]);
          lo1 = fminf(lo1, f[1]);
        }
      }
      const float d0 = hi0 - lo0, d1 = hi1 - lo1;
      w.s = d0 * d0 + d1 * d1 > mth2 ? s1 : s2;
    }
    tiles[k] = w;
  }
  __syncthreads();

  // ---- the guide image of every slot, from the raw frame as it is read:
  // staged row i of a tile is guide row clamp(g0 + i), so the clamped rows
  // of a window row's 3x3 box are consecutive staged rows
  for (int e = threadIdx.x; e < gplane; e += blockDim.x) {
    const int r = e / L.gc, c = e - r * L.gc;
    int wy, i, wx, j;
    rob_slot(r, ghw, giw, L.ty, wy, i);
    rob_slot(c, ghw, giw, L.tx, wx, j);
    const RobTile& w = tiles[wy * nwx + wx];
    if (!w.live || i >= w.rs + 2 || j >= w.cs + 2) continue;
    const int gy = clampi(w.g0 + i, 0, lh - 1), gx = clampi(w.h0 + j, 0, lw - 1);
    if (C == 1) {
      guide[e] = __ldg(raw + (size_t)gy * rw + gx);
    } else {
      const float* q = raw + (size_t)(2 * gy) * rw + 2 * gx;
      const float v[4] = {__ldg(q), __ldg(q + 1), __ldg(q + rw), __ldg(q + rw + 1)};
      float red = 0.0f, blue = 0.0f, green = 0.0f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ch = (cfa >> (2 * p)) & 3;
        if (ch == 1) {
          green = green + v[p] * iwb1;
        } else if (ch == 0) {
          red = v[p] * iwb0;
        } else {
          blue = v[p] * iwb2;
        }
      }
      guide[e] = red;
      guide[gplane + e] = green * 0.5f;
      guide[2 * gplane + e] = blue;
    }
  }
  // ---- the Dodgson tables: per work column, each pixel row of the region
  // and ring (in the tile of that row); per work row, each pixel column
  for (int e = threadIdx.x; e < nwx * L.ey; e += blockDim.x) {
    const int wx = e / L.ey;
    const int y = y0 - 2 + e - wx * L.ey;
    if (y < ey0 || y >= ey1) continue;
    const RobTile& w = tiles[(y / Ts - ty0 + 1) * nwx + wx];
    if (w.live) {
      rowt[e] = rob_axis(y, (y / Ts) * Ts, w.fy, w.Sy, w.phy, w.alo, lh, w.ok, U);
    }
  }
  for (int e = threadIdx.x; e < (L.ty + 2) * L.ex; e += blockDim.x) {
    const int wy = e / L.ex;
    const int x = x0 - 2 + e - wy * L.ex;
    if (x < ex0 || x >= ex1) continue;
    const RobTile& w = tiles[wy * nwx + x / Ts - tx0 + 1];
    if (w.live) {
      colt[e] = rob_axis(x, (x / Ts) * Ts, w.fx, w.Sx, w.phx, w.blo, lw, true, U);
    }
  }
  __syncthreads();

  // ---- the 3x3 means of every slot: window row a of a tile is guide row
  // clamp(Syc + alo + a), staged at that row minus g0
  const float inv9 = 1.0f / 9.0f;
  for (int e = threadIdx.x; e < mplane; e += blockDim.x) {
    const int r = e / L.mc, c = e - r * L.mc;
    int wy, a, wx, b;
    rob_slot(r, L.hw, L.iw, L.ty, wy, a);
    rob_slot(c, L.hw, L.iw, L.tx, wx, b);
    const RobTile& w = tiles[wy * nwx + wx];
    if (!w.live || a >= w.rs || b >= w.cs) continue;
    const int i = clampi(w.Syc + w.alo + a, 0, lh - 1) - w.g0 + rob_origin(wy, ghw, giw);
    const int j = clampi(w.Sxc + w.blo + b, 0, lw - 1) - w.h0 + rob_origin(wx, ghw, giw);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float* g = guide + k * gplane + (i - 1) * L.gc + j;
      const float sl = (g[-1] + g[L.gc - 1]) + g[2 * L.gc - 1];
      const float sm = (g[0] + g[L.gc]) + g[2 * L.gc];
      const float sr = (g[1] + g[L.gc + 1]) + g[2 * L.gc + 1];
      means[k * mplane + e] = ((sl + sm) + sr) * inv9;
    }
  }
  __syncthreads();

  // ---- R before the minimum, on the region and its ring (over the guide
  // mosaic, no longer read)
  const int exn = ex1 - ex0;
  const size_t plane = (size_t)H * W;
  for (int e = threadIdx.x; e < (ey1 - ey0) * exn; e += blockDim.x) {
    const int yr = e / exn;
    const int y = ey0 + yr, x = ex0 + e - yr * exn;
    const int wy = y / Ts - ty0 + 1, wx = x / Ts - tx0 + 1;
    const float4 ey = rowt[wx * L.ey + y - y0 + 2];
    const float4 ex = colt[wy * L.ex + x - x0 + 2];
    const int ky = __float_as_int(ey.w), kx = __float_as_int(ex.w);
    const size_t o = (size_t)y * W + x;
    // the reference's statistics, loaded before the taps so that their
    // latency hides behind the warp's arithmetic
    float rm[C], rdt[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      rm[k] = __ldg(ref_means + k * plane + o);
      rdt[k] = __ldg(ref_dt + k * plane + o);
    }
    const float rsig = __ldg(ref_sigma + o);
    const bool rvalid = ref_valid[o];
    float R = 0.0f;
    if ((ky & kx & 1) && rvalid) {
      const float* m = means + (rob_origin(wy, L.hw, L.iw) + (ky >> 1)) * L.mc +
                       rob_origin(wx, L.hw, L.iw) + (kx >> 1);
      const float wyv[3] = {ey.x, ey.y, ey.z};
      const float wxv[3] = {ex.x, ex.y, ex.z};
      float acc[C];
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] = 0.0f;
      float w_acc = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float wgt = wyv[i] * wxv[j];
#pragma unroll
          for (int k = 0; k < C; ++k) acc[k] += m[k * mplane + i * L.mc + j] * wgt;
          w_acc += wgt;
        }
      }
      float d_sq = 0.0f;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float d = fabsf(rm[k] - acc[k] / w_acc);
        const float dt = rdt[k];
        const float sq = d * d;
        const float sh = sq / (sq + dt * dt);
        const float term = sq * sh * sh;
        d_sq = k == 0 ? term : d_sq + term;
      }
      const float v = tiles[wy * nwx + wx].s * expf(-d_sq / rsig) - thr;
      R = v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
    }
    rpre[(y - y0 + 2) * L.ex + x - x0 + 2] = R;
  }
  __syncthreads();

  // ---- the 5x5 minimum: minima of 5 rows per region row and ring column,
  // then of 5 columns per pixel, 4 pixels a thread
  for (int e = threadIdx.x; e < (y1 - y0) * exn; e += blockDim.x) {
    const int r = e / exn;
    const int Y = y0 + r, x = ex0 + e - r * exn;
    const float* col = rpre + x - x0 + 2;
    float v = col[(clampi(Y - 2, 0, H - 1) - y0 + 2) * L.ex];
#pragma unroll
    for (int d = -1; d <= 2; ++d) {
      v = rob_min(v, col[(clampi(Y + d, 0, H - 1) - y0 + 2) * L.ex]);
    }
    vmin[r * L.ex + x - x0 + 2] = v;
  }
  __syncthreads();
  const int gpr = (L.tx * Ts + 3) / 4;
  const bool vec = (W % 4) == 0 && (x0 % 4) == 0;
  for (int g = threadIdx.x; g < L.ty * Ts * gpr; g += blockDim.x) {
    const int r = g / gpr;
    const int Y = y0 + r, X = x0 + 4 * (g - r * gpr);
    if (Y >= y1 || X >= x1) continue;
    const float* row = vmin + r * L.ex - x0 + 2;
    float cm[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) cm[m] = row[clampi(X - 2 + m, 0, ex1 - 1)];
    float res[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      res[p] = rob_min(rob_min(rob_min(rob_min(cm[p], cm[p + 1]), cm[p + 2]), cm[p + 3]),
                       cm[p + 4]);
    }
    float* o = out + (size_t)Y * W + X;
    if (vec && X + 4 <= x1) {
      *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (X + p < x1) o[p] = res[p];
      }
    }
  }
}

// ---- host side

template <int C, int TS>
static int launch_robustness(const float* raw, int rw, const float* ref_means,
                             const float* ref_dt, const float* ref_sigma,
                             const unsigned char* ref_valid, const float* flow,
                             int fny, int fnx, int Ts, int H, int W, int cfa,
                             float iwb0, float iwb1, float iwb2, float mth2, float s1,
                             float s2, float thr, float* out, cudaStream_t stream) {
  constexpr int U = C == 3 ? 2 : 1;
  const RobLayout L = rob_layout(Ts, U, C);
  auto kernel = robustness_kernel<C, TS>;
  if (L.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int nty = (H + Ts - 1) / Ts, ntx = (W + Ts - 1) / Ts;
  const dim3 grid((ntx + L.tx - 1) / L.tx, (nty + L.ty - 1) / L.ty);
  if (H > 0 && W > 0) {
    kernel<<<grid, ROB_THREADS, L.smem_bytes, stream>>>(
        raw, rw, ref_means, ref_dt, ref_sigma, ref_valid, flow, fny, fnx, Ts, H, W,
        cfa, iwb0, iwb1, iwb2, mth2, s1, s2, thr, out);
  }
  return (int)cudaGetLastError();
}

static bool rob_fixed(int Ts) { return Ts == 16 || Ts == 32 || Ts == 64; }

// raw (rh, rw); c = 3 Bayer (the 2x2 phases' channels packed 2 bits each in
// cfa, phase 2 i + j at bit 2 (2 i + j)), c = 1 grey; the map is (H, W) =
// the raw grid of whole quads (Bayer) or the frame (grey).
extern "C" int hmsr_robustness(const float* raw, int rh, int rw,
                               const float* ref_means, const float* ref_dt,
                               const float* ref_sigma, const unsigned char* ref_valid,
                               const float* flow, int fny, int fnx, int c, int Ts,
                               int cfa, float iwb0, float iwb1, float iwb2, float mth2,
                               float s1, float s2, float thr, float* out, void* stream) {
  if ((c != 1 && c != 3) || Ts < 2 || Ts % (c == 3 ? 2 : 1) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int u = c == 3 ? 2 : 1;
  const int H = rh / u * u, W = rw / u * u;
  if (fny < (H + Ts - 1) / Ts || fnx < (W + Ts - 1) / Ts) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
#define ROB_ARGS                                                                    \
  raw, rw, ref_means, ref_dt, ref_sigma, ref_valid, flow, fny, fnx, Ts, H, W, cfa, \
      iwb0, iwb1, iwb2, mth2, s1, s2, thr, out, s
  if (c == 3) {
    if (Ts == 16) return launch_robustness<3, 16>(ROB_ARGS);
    if (Ts == 32) return launch_robustness<3, 32>(ROB_ARGS);
    if (Ts == 64) return launch_robustness<3, 64>(ROB_ARGS);
    return launch_robustness<3, 0>(ROB_ARGS);
  }
  if (Ts == 16) return launch_robustness<1, 16>(ROB_ARGS);
  if (Ts == 32) return launch_robustness<1, 32>(ROB_ARGS);
  if (Ts == 64) return launch_robustness<1, 64>(ROB_ARGS);
  return launch_robustness<1, 0>(ROB_ARGS);
#undef ROB_ARGS
}

// The launch layout of (Ts, c): out[0] tiles per block down, out[1] across,
// out[2] threads, out[3] dynamic shared memory bytes, out[4] 1 when Ts has an
// instantiation of its own.
extern "C" int hmsr_robustness_layout(int Ts, int c, int* out) {
  if ((c != 1 && c != 3) || Ts < 2) return (int)cudaErrorInvalidValue;
  const RobLayout L = rob_layout(Ts, c == 3 ? 2 : 1, c);
  out[0] = L.ty;
  out[1] = L.tx;
  out[2] = ROB_THREADS;
  out[3] = L.smem_bytes;
  out[4] = rob_fixed(Ts) ? 1 : 0;
  return 0;
}
