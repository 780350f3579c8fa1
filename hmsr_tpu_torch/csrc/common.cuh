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

// ---------------------------------------------------------------------------
// ICA Gauss-Newton right-hand side (K2, and every iteration of K3)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float zero_tap(const float* __restrict__ mov,
                                          int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? mov[(size_t)y * w + x] : 0.0f;
}

// This thread's share of b = sum -grad_ref * (warp(moving) - ref) over tile
// (ty, tx) at flow (ax, ay): the flow splits by truncation toward zero
// (negative flows give negative fractions), the bilinear taps read 0 out of
// bounds, and zero taps still contribute gradt = -ref.
__device__ __forceinline__ void ica_partial(
    const float* __restrict__ ref, const float* __restrict__ gx,
    const float* __restrict__ gy, int ref_w, const float* __restrict__ mov,
    int h, int w, int ty, int tx, int ts, float ax, float ay, float& s0,
    float& s1) {
  const float ix = truncf(ax);
  const float iy = truncf(ay);
  const float frac_x = ax - ix;
  const float frac_y = ay - iy;
  const int oy = ty * ts + (int)iy;
  const int ox = tx * ts + (int)ix;
  s0 = 0.0f;
  s1 = 0.0f;
  for (int p = threadIdx.x; p < ts * ts; p += blockDim.x) {
    const int y = p / ts;
    const int x = p - y * ts;
    const float m00 = zero_tap(mov, h, w, oy + y, ox + x);
    const float m01 = zero_tap(mov, h, w, oy + y, ox + x + 1);
    const float m10 = zero_tap(mov, h, w, oy + y + 1, ox + x);
    const float m11 = zero_tap(mov, h, w, oy + y + 1, ox + x + 1);
    const float top = m00 + (m01 - m00) * frac_x;
    const float bot = m10 + (m11 - m10) * frac_x;
    const float interp = top + (bot - top) * frac_y;
    const size_t ri = (size_t)(ty * ts + y) * ref_w + tx * ts + x;
    const float gradt = interp - ref[ri];
    s0 += -gx[ri] * gradt;
    s1 += -gy[ri] * gradt;
  }
}

// Block-wide sum of (s0, s1) for blockDim.x a multiple of 32 (at most
// 1024): warp shuffles, then thread 0 adds the warps' sums in order. The
// result is valid in thread 0 only; callers __syncthreads() before reusing
// ``red``.
__device__ __forceinline__ void block_sum2(float& s0, float& s1,
                                           float (*red)[32]) {
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, o);
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s0;
    red[1][warp] = s1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
      t0 += red[0][i];
      t1 += red[1][i];
    }
    s0 = t0;
    s1 = t1;
  }
}

// Threads per tile of the ICA kernels: one per tile pixel, at most 256.
inline int ica_threads(int ts) {
  return ts * ts < 256 ? ((ts * ts + 31) / 32) * 32 : 256;
}

// ---------------------------------------------------------------------------
// Merge accumulation (K5, and every frame of K5')
// ---------------------------------------------------------------------------

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

// One Bayer frame's contribution at HR pixel (R, C): the kernel-weighted sum
// of its 3x3 raw taps per CFA channel (vals) and the sum of the weights
// (accs), in the tap order of merge_plain. K5 adds them to num/den once per
// launch, K5' once per frame of its chunk: both call this function, so the
// two cannot drift and F K5 launches equal one K5' launch bit for bit.
// Semantics of hmsr_tpu/models/merge_tiled.py:merge_tiled (Bayer, steerable
// kernel, integer scale s):
//   - the flow is constant per (Ts*s)^2 HR tile; the 3x3 raw neighbourhood is
//     centred at (Sy + 1) + (r_loc + ph_y) // s with Sy = floor_div(ty*B +
//     floor(0.5 + s*fy), s) - 1; values come from the tile window at the
//     CLIPPED origin Syc (zero outside the frame), and a clipped tile is
//     invalid as a whole (ok_tile);
//   - the covariance is bilinearly interpolated on the grey grid from the
//     window at the clipped origin S2yc; index -1 holds the linear
//     extrapolation 2 c[0] - c[1] (per axis, rows first), beyond it edge
//     values;
//   - the 2x2 inverse is unguarded; w = exp(-1/2 max(0, d^T Omega^-1 d)) * r;
//   - the CFA channel comes from the floor parity of the sample's raw row
//     and column.
__device__ __forceinline__ void merge_pixel(
    const float* __restrict__ comp, int H, int W,
    const float* __restrict__ flow, int fnx, const float* __restrict__ covs,
    int gh, int gw, const float* __restrict__ rob, int R, int C, int Ts, int s,
    int cfa00, int cfa01, int cfa10, int cfa11, float* vals, float* accs) {
  const int g = 2;
  const int B = Ts * s;
  const int ty = R / B;
  const int tx = C / B;
  const int rl_y = R - ty * B;
  const int rl_x = C - tx * B;
  const float fx = flow[2 * (ty * fnx + tx)];
  const float fy = flow[2 * (ty * fnx + tx) + 1];
  const float sf = (float)s;

  // ---- raw window bookkeeping
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
  const int q_y = (rl_y + ph_y) / s;  // non-negative operands
  const int q_x = (rl_x + ph_x) / s;
  const int center_i = Sy + 1 + q_y;
  const int center_j = Sx + 1 + q_x;

  const float lr_y = ((float)R + 0.5f) / sf;
  const float lr_x = ((float)C + 0.5f) / sf;
  const float lr_mov_y = lr_y + fy;
  const float lr_mov_x = lr_x + fx;
  const bool inb_center = lr_mov_y >= 0.0f && lr_mov_y < (float)H &&
                          lr_mov_x >= 0.0f && lr_mov_x < (float)W && ok_tile;
  const float local_r =
      rob[(size_t)min(R / s, H - 1) * W + min(C / s, W - 1)];

  // ---- covariance interpolation
  const int sg = s * g;
  const int CWIN = Ts / g + 4;
  const int CPAD = CWIN + 1;
  const float halfsg = 0.5f * (float)sg;
  const int base2_y =
      ty * B + (int)floorf(__fsub_rn(__fadd_rn(0.5f, __fmul_rn(sf, fy)), halfsg));
  const int S2y = floordiv(base2_y, sg) - 1;
  const int ph2_y = base2_y - sg * (S2y + 1);
  const int base2_x =
      tx * B + (int)floorf(__fsub_rn(__fadd_rn(0.5f, __fmul_rn(sf, fx)), halfsg));
  const int S2x = floordiv(base2_x, sg) - 1;
  const int ph2_x = base2_x - sg * (S2x + 1);
  const int S2yc = clampi(S2y, -CPAD, gh + CPAD - CWIN);
  const int S2xc = clampi(S2x, -CPAD, gw + CPAD - CWIN);
  const int q2_y = (rl_y + ph2_y) / sg;
  const int q2_x = (rl_x + ph2_x) / sg;
  const float frac_y = (lr_mov_y / (float)g - 0.5f) - (float)(S2y + 1 + q2_y);
  const float frac_x = (lr_mov_x / (float)g - 0.5f) - (float)(S2x + 1 + q2_x);
  const int ci = S2yc + 1 + q2_y;
  const int cj = S2xc + 1 + q2_x;
  float cc[3];
  for (int k = 0; k < 3; ++k) {
    const float* cv = covs + (size_t)k * gh * gw;
    const float c00 = cov_at(cv, gh, gw, ci, cj);
    const float c01 = cov_at(cv, gh, gw, ci, cj + 1);
    const float c10 = cov_at(cv, gh, gw, ci + 1, cj);
    const float c11 = cov_at(cv, gh, gw, ci + 1, cj + 1);
    const float top = c00 + frac_x * (c01 - c00);
    const float bot = c10 + frac_x * (c11 - c10);
    cc[k] = top + frac_y * (bot - top);
  }
  const float det = cc[0] * cc[2] - cc[1] * cc[1];
  const float inv_det = 1.0f / det;
  const float ixx = inv_det * cc[2];
  const float ixy = -inv_det * cc[1];
  const float iyy = inv_det * cc[0];

  // ---- 3x3 accumulation
  const float dist_ref_y = lr_mov_y - 0.5f;
  const float dist_ref_x = lr_mov_x - 0.5f;
  const float wr = inb_center ? local_r : 0.0f;
  for (int k = 0; k < 3; ++k) {
    vals[k] = 0.0f;
    accs[k] = 0.0f;
  }
  for (int di = -1; di <= 1; ++di) {
    const int i_g = center_i + di;
    const bool inb_i = i_g >= 0 && i_g < H;
    const int pi = floormod(i_g, 2);
    const float dist_y = (float)i_g - dist_ref_y;
    const int vy = Syc + 1 + di + q_y;
    for (int dj = -1; dj <= 1; ++dj) {
      const int j_g = center_j + dj;
      const bool inb = inb_i && j_g >= 0 && j_g < W;
      const int pj = floormod(j_g, 2);
      const float dist_x = (float)j_g - dist_ref_x;
      const int vx = Sxc + 1 + dj + q_x;
      const float c = (vy >= 0 && vy < H && vx >= 0 && vx < W)
                          ? comp[(size_t)vy * W + vx] : 0.0f;
      float z = ixx * dist_x * dist_x + 2.0f * ixy * dist_x * dist_y +
                iyy * dist_y * dist_y;
      z = fmaxf(z, 0.0f);
      const float wgt = expf(-0.5f * z) * wr * (inb ? 1.0f : 0.0f);
      const int ch = pi == 0 ? (pj == 0 ? cfa00 : cfa01)
                             : (pj == 0 ? cfa10 : cfa11);
      vals[ch] += wgt * c;
      accs[ch] += wgt;
    }
  }
}
