// K5: merge accumulation of one non-reference frame (Alg. 4) into (num, den).
//
// Replaces hmsr_tpu/ops/pallas_merge.py:_merge_group_kernel (launched by
// _merge_frames_pallas through merge_pallas). Semantics of
// hmsr_tpu/models/merge_tiled.py:merge_tiled, per HR pixel (Bayer, steerable
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
//
// Bound on the H100: device memory — per HR pixel a read-modify-write of 6
// accumulator floats (48 bytes) against ~120 flops. Design: one thread per HR
// pixel; each thread owns its num/den entries, so the in-place update has no
// race and needs no atomics; raw, covariance and robustness taps are shared
// by neighbouring threads through the caches.
#include "common.cuh"

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

__global__ void merge_kernel(const float* __restrict__ comp, int H, int W,
                             const float* __restrict__ flow, int fnx,
                             const float* __restrict__ covs, int gh, int gw,
                             const float* __restrict__ rob,
                             float* __restrict__ num, float* __restrict__ den,
                             int out_h, int out_w, int Ts, int s, int cfa00,
                             int cfa01, int cfa10, int cfa11) {
  const int C = blockIdx.x * blockDim.x + threadIdx.x;
  const int R = blockIdx.y;
  if (C >= out_w) return;
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
  float vals[3] = {0.0f, 0.0f, 0.0f};
  float accs[3] = {0.0f, 0.0f, 0.0f};
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
  const size_t plane = (size_t)out_h * out_w;
  const size_t o = (size_t)R * out_w + C;
  for (int k = 0; k < 3; ++k) {
    num[k * plane + o] += vals[k];
    den[k * plane + o] += accs[k];
  }
}

extern "C" int hmsr_merge(const float* comp, int H, int W, const float* flow,
                          int fnx, const float* covs, int gh, int gw,
                          const float* rob, float* num, float* den, int out_h,
                          int out_w, int Ts, int s, int cfa00, int cfa01,
                          int cfa10, int cfa11, void* stream) {
  const int threads = 256;
  dim3 grid((out_w + threads - 1) / threads, out_h);
  if (out_h > 0 && out_w > 0) {
    merge_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        comp, H, W, flow, fnx, covs, gh, gw, rob, num, den, out_h, out_w, Ts,
        s, cfa00, cfa01, cfa10, cfa11);
  }
  return (int)cudaGetLastError();
}
