// K7: the fused form's refill and divide, per group of the accumulators.
// From K6's padded (c, h, w) = (c, nty*B, ntx*B) num/den to the cropped
// (c, out_h, out_w) image, each B-row slab (tiles = 0) or each (B, B) tile
// (tiles = 1) on its own:
//   good = den > starved;  n = good ? num : 0;  d = good ? den : 0;
//   twice: the zero-padded 5x5 box sums of n and d (rows summed first, then
//   columns, each as ((((x-2 + x-1) + x0) + x+1) + x+2)); n, d take them
//   where !good; good = d > starved;
//   image = n / max(d, eps), IEEE division;
// with zero context past the group's edges. The padded rows and columns
// take part as context; the store crops them.
//
// Replaces the normalization of hmsr_tpu/models/merge_slab.py:merge_burst_slab
// (normalize_accum inside one_row, :377-383) and of
// hmsr_tpu/models/merge_fused.py:merge_burst_tiled (:356), XLA code of the
// JAX package (no pl.pallas_call there); in the port, the plain twin is
// ops/accumfix.py:normalize_groups followed by the crop, which it matches
// bit for bit: the same adds in the same order, the same compares, and the
// IEEE division (the library is built with -fmad=false; nothing here could
// contract anyway).
//
// Bound on the H100: bytes. num and den read once (8 bytes per padded HR
// pixel and channel), the image written once (4 bytes per image pixel and
// channel): 1.73 GB at the main path (3 x 6016 x 8000 -> 3 x 6000 x 8000),
// 0.52 ms. The plain twin makes ~40 full-size passes of torch elementwise
// kernels over the same data.
//
// Design: one block per (B rows x wc columns) piece of a group and one
// channel, its 256 threads as 8 rows of 32 columns (no index division). It
// stages n and d (already masked) with a 4-column halo on each side (two
// passes of a radius-2 box) and two zero rows above and below, zero past
// the group's edge, in shared memory; both passes run there (row sums into a
// second pair of buffers, then the column sums and the update in place), and
// the image is written once. The staged width ww = wc + 8 is 64 for B <= 64
// and 32 above it, so a block's buffers stay within 100 KB at B = 192 (Ts =
// 64, x3).
#include "common.cuh"

constexpr int REFILL_COLS = 32;   // threads along a row
constexpr int REFILL_ROWS = 8;    // rows of threads
constexpr int REFILL_HALO = 4;

// Staged columns (piece and halo) of a block at group height B: 64 or 32.
__host__ __device__ inline int refill_width(int B) { return B <= 64 ? 64 : 32; }

// One pass over staged columns [lo, hi): row sums of n and d (row stride
// ww, two zero rows above and below the group's B rows) into tn and td,
// then at columns [lo + 2, hi - 2) the column sums and the update, in place;
// columns outside the group (col0 + column outside [gx0, gx1)) stay 0.
__device__ __forceinline__ void refill_pass(float* n, float* d, float* tn,
                                            float* td, int B, int ww, int lo,
                                            int hi, int col0, int gx0, int gx1,
                                            float starved) {
  const int tx = threadIdx.x % REFILL_COLS, ty = threadIdx.x / REFILL_COLS;
  for (int y = ty; y < B; y += REFILL_ROWS) {
    for (int x = lo + tx; x < hi; x += REFILL_COLS) {
      const int o = y * ww + x;  // rows y .. y+4 of n: image rows y-2 .. y+2
      float sn = __fadd_rn(n[o], n[o + ww]);
      float sd = __fadd_rn(d[o], d[o + ww]);
      sn = __fadd_rn(sn, n[o + 2 * ww]);
      sd = __fadd_rn(sd, d[o + 2 * ww]);
      sn = __fadd_rn(sn, n[o + 3 * ww]);
      sd = __fadd_rn(sd, d[o + 3 * ww]);
      tn[o] = __fadd_rn(sn, n[o + 4 * ww]);
      td[o] = __fadd_rn(sd, d[o + 4 * ww]);
    }
  }
  __syncthreads();
  for (int y = ty; y < B; y += REFILL_ROWS) {
    for (int x = lo + 2 + tx; x < hi - 2; x += REFILL_COLS) {
      const int gx = col0 + x;
      const int o = y * ww + x;
      const int on = o + 2 * ww;
      if (gx < gx0 || gx >= gx1 || d[on] > starved) continue;
      float sn = __fadd_rn(tn[o - 2], tn[o - 1]);
      float sd = __fadd_rn(td[o - 2], td[o - 1]);
      sn = __fadd_rn(sn, tn[o]);
      sd = __fadd_rn(sd, td[o]);
      sn = __fadd_rn(sn, tn[o + 1]);
      sd = __fadd_rn(sd, td[o + 1]);
      n[on] = __fadd_rn(sn, tn[o + 2]);
      d[on] = __fadd_rn(sd, td[o + 2]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(REFILL_COLS * REFILL_ROWS)
    refill_kernel(const float* __restrict__ num, const float* __restrict__ den,
                  float* __restrict__ out, int h, int w, int B, int gw,
                  int pieces, int out_h, int out_w, float starved, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int ww = refill_width(B);
  const int wc = ww - 2 * REFILL_HALO;
  float* n = smem;                   // (B + 4) x ww
  float* d = n + (B + 4) * ww;       // (B + 4) x ww
  float* tn = d + (B + 4) * ww;      // B x ww
  float* td = tn + B * ww;           // B x ww
  const int tx = threadIdx.x % REFILL_COLS, ty = threadIdx.x / REFILL_COLS;
  const int ch = blockIdx.z;
  const int gy0 = blockIdx.y * B;
  const int g = blockIdx.x / pieces;
  const int gx0 = g * gw;
  const int gx1 = gx0 + gw;
  const int x0 = gx0 + (blockIdx.x - g * pieces) * wc;
  if (gy0 >= out_h || x0 >= out_w) return;  // the piece holds no image pixel
  const int col0 = x0 - REFILL_HALO;         // global column of staged column 0
  const size_t plane = (size_t)h * w;
  const float* nb = num + ch * plane + (size_t)gy0 * w;
  const float* db = den + ch * plane + (size_t)gy0 * w;
  for (int y = ty; y < B + 4; y += REFILL_ROWS) {
    for (int xs = tx; xs < ww; xs += REFILL_COLS) {
      const int x = col0 + xs;
      float nv = 0.0f, dv = 0.0f;
      if (y >= 2 && y < B + 2 && x >= gx0 && x < gx1) {
        const float dd = db[(size_t)(y - 2) * w + x];
        if (dd > starved) {
          nv = nb[(size_t)(y - 2) * w + x];
          dv = dd;
        }
      }
      n[y * ww + xs] = nv;
      d[y * ww + xs] = dv;
    }
  }
  __syncthreads();
  refill_pass(n, d, tn, td, B, ww, 0, ww, col0, gx0, gx1, starved);
  refill_pass(n, d, tn, td, B, ww, 2, ww - 2, col0, gx0, gx1, starved);
  const int wo = min(min(x0 + wc, gx1), out_w) - x0;
  const int rows = min(B, out_h - gy0);
  float* ob = out + ch * (size_t)out_h * out_w + (size_t)gy0 * out_w + x0;
  for (int y = ty; y < rows; y += REFILL_ROWS) {
    for (int x = tx; x < wo; x += REFILL_COLS) {
      const int o = (y + 2) * ww + REFILL_HALO + x;
      const float dv = d[o];
      ob[(size_t)y * out_w + x] = __fdiv_rn(n[o], dv < eps ? eps : dv);
    }
  }
}

// Dynamic shared memory of a K7 block: two (B + 4) x ww and two B x ww
// float buffers.
inline int refill_smem_bytes(int B) {
  return 4 * refill_width(B) * (2 * (B + 4) + 2 * B);
}

// num, den (c, h, w) with h, w whole multiples of B; out (c, out_h, out_w),
// out_h <= h, out_w <= w; tiles 0 refills per B-row slab, 1 per (B, B) tile.
// Returns a cudaError_t.
extern "C" int hmsr_refill(const float* num, const float* den, float* out,
                           int c, int h, int w, int B, int tiles, int out_h,
                           int out_w, float starved, float eps, void* stream) {
  if (c < 1 || B < 1 || h < B || w < B || h % B || w % B || out_h < 1 ||
      out_w < 1 || out_h > h || out_w > w) {
    return (int)cudaErrorInvalidValue;
  }
  const int gw = tiles ? B : w;
  const int wc = refill_width(B) - 2 * REFILL_HALO;
  const int pieces = (gw + wc - 1) / wc;
  const int smem = refill_smem_bytes(B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        refill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((w / gw) * pieces, h / B, c);
  refill_kernel<<<grid, REFILL_COLS * REFILL_ROWS, smem, (cudaStream_t)stream>>>(
      num, den, out, h, w, B, gw, pieces, out_h, out_w, starved, eps);
  return (int)cudaGetLastError();
}
