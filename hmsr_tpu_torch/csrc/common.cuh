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
