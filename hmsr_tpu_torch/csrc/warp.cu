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
// Bound on the H100: device memory (about 9 reads served by cache and 4
// writes of 4 bytes per output pixel, ~40 flops). Design: one thread per raw
// output pixel, looping over the (<= 4) channels that share the weights;
// rows of threads read neighbouring stats addresses.
#include "common.cuh"

__device__ __forceinline__ float dogson(float x) {
  const float ax = fabsf(x);
  if (ax <= 0.5f) return -2.0f * ax * ax + 1.0f;
  if (ax <= 1.5f) return ax * ax - 2.5f * ax + 1.5f;
  return 0.0f;
}

__global__ void warp_kernel(const float* __restrict__ stats, int c, int lh,
                            int lw, const float* __restrict__ flow, int fnx,
                            int Ts, int u, int H, int W,
                            float* __restrict__ out,
                            unsigned char* __restrict__ valid) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y;
  if (X >= W) return;
  const int ty = Y / Ts;
  const int tx = X / Ts;
  const float fx = flow[2 * (ty * fnx + tx)];
  const float fy = flow[2 * (ty * fnx + tx) + 1];
  const int WIN = Ts / u + 4;
  const int PAD = WIN + 1;

  const int base_y = ty * Ts + (int)floorf(fy + 0.5f);
  const int Sy = floordiv(base_y, u) - 1;
  const int ph_y = base_y - u * (Sy + 1);
  const int base_x = tx * Ts + (int)floorf(fx + 0.5f);
  const int Sx = floordiv(base_x, u) - 1;
  const int ph_x = base_x - u * (Sx + 1);
  const int Syc = clampi(Sy, -PAD, lh + PAD - WIN);
  const int Sxc = clampi(Sx, -PAD, lw + PAD - WIN);
  const bool ok_tile = (Syc == Sy) && (Sxc == Sx);

  const int q_y = (Y - ty * Ts + ph_y) / u;  // non-negative operands
  const int q_x = (X - tx * Ts + ph_x) / u;
  const int center_y = Sy + 1 + q_y;
  const int center_x = Sx + 1 + q_x;
  const float lr_y = ((float)Y + fy + 0.5f) / (float)u - 0.5f;
  const float lr_x = ((float)X + fx + 0.5f) / (float)u - 0.5f;
  const bool ok = (lr_y >= 0.0f) && (lr_y < (float)lh) && (lr_x >= 0.0f) &&
                  (lr_x < (float)lw) && ok_tile;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float w_acc = 0.0f;
  const size_t plane = (size_t)lh * lw;
  for (int i = -1; i <= 1; ++i) {
    const float wy = dogson((float)clampi(center_y + i, 0, lh - 1) - lr_y);
    const int vy = clampi(Syc + 1 + i + q_y, 0, lh - 1);
    for (int j = -1; j <= 1; ++j) {
      const float wgt =
          wy * dogson((float)clampi(center_x + j, 0, lw - 1) - lr_x);
      const int vx = clampi(Sxc + 1 + j + q_x, 0, lw - 1);
      const float* sp = stats + (size_t)vy * lw + vx;
      for (int k = 0; k < c; ++k) acc[k] += sp[k * plane] * wgt;
      w_acc += wgt;
    }
  }
  const size_t o = (size_t)Y * W + X;
  for (int k = 0; k < c; ++k) out[k * (size_t)H * W + o] = acc[k] / w_acc;
  valid[o] = ok ? 1 : 0;
}

extern "C" int hmsr_upscale_warp(const float* stats, int c, int lh, int lw,
                                 const float* flow, int fnx, int Ts, int u,
                                 int H, int W, float* out,
                                 unsigned char* valid, void* stream) {
  const int threads = 256;
  dim3 grid((W + threads - 1) / threads, H);
  if (H > 0 && W > 0) {
    warp_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        stats, c, lh, lw, flow, fnx, Ts, u, H, W, out, valid);
  }
  return (int)cudaGetLastError();
}
