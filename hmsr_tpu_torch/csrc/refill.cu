// K7: the refill of starved pixels and the divide, from num/den (c, h, w) to
// the (c, out_h, out_w) image, per group of the accumulators:
//   good = den > starved;  n = good ? num : 0;  d = good ? den : 0;
//   twice: the zero-padded 5x5 box sums of n and d (rows summed first, then
//   columns, each as ((((x-2 + x-1) + x0) + x+1) + x+2)); n, d take them
//   where !good; good = d > starved;
//   image = n / max(d, eps), IEEE division;
// with zero context past the group's edges. Three group layouts share the
// one routine:
// - slab: each gh = B row slab of K6's padded (c, nty*B, ntx*B)
//   accumulators (gw = w), the image their (out_h, out_w) crop;
// - tile: each (B, B) tile of them (gh = gw = B);
// - image: the whole (c, h, w) accumulators are one group (gh = h, gw = w,
//   out = h x w), and the refill is kept only within `border` pixels of an
//   edge; every other pixel is the plain guarded divide num / max(den, eps).
//   border < 0 keeps it everywhere.
//
// Replaces the normalization of the JAX package's fused merges
// (hmsr_tpu/models/merge_slab.py:383 normalize_accum per slab,
// hmsr_tpu/models/merge_fused.py:356 per tile: the slab and tile layouts)
// and the border-strip normalization of its other single-device
// pipelines (hmsr_tpu/models/pipeline.py:289, 325, 365) and of the sharded
// pipeline (hmsr_tpu/parallel/sharded.py:226), normalize_accum(num, den,
// refill_border=32): the image layout. All are XLA code (no pl.pallas_call).
// The strips with their 8-px margin equal the whole-image refill at every
// border pixel, and a well-fed pixel keeps its divide whatever its
// neighbours hold; so the image layout is the whole-image refill kept at
// the border (ops/accumfix.py:normalize_border_whole), which equals
// normalize_accum(refill_border=B) bit for bit. Against its plain twins
// (normalize_groups and the crop; normalize_accum) it is bit for bit: the
// same adds in the same order, the same compares, IEEE division (the
// library is built with -fmad=false; nothing here could contract anyway).
//
// Bound on the H100: bytes. num and den read once at every output pixel (8
// bytes per pixel and channel), the image written once (4 bytes): 1.73 GB
// at the main path (3 x 6000 x 8000), 0.52 ms at 3.35 TB/s.
//
// Design. A well-fed pixel's value is its divide, and starved pixels are
// rare in real bursts, so the kernel is a streaming divide with a sparse
// refill. One block of 256 threads per piece of 32 x 64 output pixels of
// one group and channel:
// - fast path: each thread loads two 4-pixel quads of num and of den, 16
//   bytes each with no L1 allocation, all four loads in flight before any
//   use; it votes whether any of its pixels is starved (!(den > starved): a
//   NaN den is starved, as in the plain `good`) and inside the refill
//   region. Where no thread does (__syncthreads_or), the block stores the
//   divides with 16-byte streaming stores and ends. Only the output pixels
//   are read: no padded rows or columns past the crop, no halo.
// - slow path, only in blocks that voted: the piece goes from the registers
//   into shared memory, and a 4-pixel halo ring around it from device
//   memory (its loads all in flight together; real context where the group
//   continues, zero past its edges). Pass 1's vertical sums come from a
//   sliding window of five registers down a column (one shared load per
//   sum instead of five); its horizontal sums and updates run only at
//   starved pixels. Pass 2 runs only if a pixel of the piece is still
//   starved after pass 1. The store takes the refilled value where the
//   vote bit is set and the registers' divide elsewhere.
// - widths that are no multiple of 4, unaligned pointers or strides take
//   the same code with scalar loads and stores.
// 43.8 KB of static shared memory and at most 64 registers: 4 blocks (1024
// threads, 64 KB of loads in flight) per SM. 5 blocks (at most 51
// registers) spill, and were slower on the main path's accumulators
// (PERF.md §6).
#include "common.cuh"

constexpr int RF_THREADS = 256;
constexpr int RF_ROWS = 32;                       // output rows of a piece
constexpr int RF_COLS = 64;                       // output columns of a piece
constexpr int RF_HALO = 4;                        // two passes of a radius-2 box
constexpr int RF_SR = RF_ROWS + 2 * RF_HALO;      // staged rows
constexpr int RF_SC = RF_COLS + 2 * RF_HALO;      // staged columns
constexpr int RF_QUADS = RF_COLS / 4;             // quads in a piece's row
constexpr int RF_QROWS = RF_THREADS / RF_QUADS;   // rows of quads per sweep
constexpr int RF_PER = RF_ROWS / RF_QROWS;        // quads per thread
constexpr int RF_RUN = 12;                        // rows per vertical window
// the staged halo ring: 4 rows above and below, 4 columns left and right
constexpr int RF_RING = 2 * RF_HALO * RF_SC + 2 * RF_HALO * RF_ROWS;
constexpr int RF_RING_PER = (RF_RING + RF_THREADS - 1) / RF_THREADS;

// Staged row and column of the i-th position of the halo ring (top rows,
// bottom rows, left columns, right columns); row -1 past its end.
__device__ __forceinline__ void ring_position(int i, int& sy, int& sx) {
  constexpr int band = RF_HALO * RF_SC, side = RF_HALO * RF_ROWS;
  if (i < band) {
    sy = i / RF_SC;
    sx = i % RF_SC;
  } else if (i < 2 * band) {
    sy = RF_HALO + RF_ROWS + (i - band) / RF_SC;
    sx = (i - band) % RF_SC;
  } else if (i < 2 * band + 2 * side) {
    const int j = i - 2 * band;
    sy = RF_HALO + (j % side) / RF_HALO;
    sx = (j < side ? 0 : RF_HALO + RF_COLS) + j % RF_HALO;
  } else {
    sy = sx = -1;
  }
}

__device__ __forceinline__ float4 load_stream4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float guarded_div(float n, float d, float eps) {
  return __fdiv_rn(n, d < eps ? eps : d);  // a NaN d stays NaN, as torch.clamp
}

// Vertical 5-row sums of n and d at staged rows [ra, rb) and columns
// [ca, cb) into tn, td (row r stored at row r - 2), each column walked by
// one thread per run of RF_RUN rows with a window of five registers.
__device__ __forceinline__ void refill_vertical(const float (*n)[RF_SC],
                                                const float (*d)[RF_SC],
                                                float (*tn)[RF_SC], float (*td)[RF_SC],
                                                int ra, int rb, int ca, int cb) {
  const int cols = cb - ca;
  const int runs = (rb - ra + RF_RUN - 1) / RF_RUN;
  for (int i = threadIdx.x; i < cols * runs; i += RF_THREADS) {
    const int x = ca + i % cols;
    const int r0 = ra + (i / cols) * RF_RUN;
    const int r1 = min(r0 + RF_RUN, rb);
    float n0 = n[r0 - 2][x], n1 = n[r0 - 1][x], n2 = n[r0][x], n3 = n[r0 + 1][x];
    float d0 = d[r0 - 2][x], d1 = d[r0 - 1][x], d2 = d[r0][x], d3 = d[r0 + 1][x];
    for (int r = r0; r < r1; ++r) {
      const float n4 = n[r + 2][x], d4 = d[r + 2][x];
      tn[r - 2][x] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(n0, n1), n2), n3), n4);
      td[r - 2][x] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(d0, d1), d2), d3), d4);
      n0 = n1; n1 = n2; n2 = n3; n3 = n4;
      d0 = d1; d1 = d2; d2 = d3; d3 = d4;
    }
  }
}

// Horizontal 5-column sums of tn, td and the update of n, d at the starved
// positions of staged rows [ra, rb) and columns [ca, cb). Returns whether
// this thread left a position of rows [pa, pb) x columns [qa, qb) starved.
__device__ __forceinline__ bool refill_horizontal(float (*n)[RF_SC], float (*d)[RF_SC],
                                                  const float (*tn)[RF_SC],
                                                  const float (*td)[RF_SC], int ra,
                                                  int rb, int ca, int cb, int pa, int pb,
                                                  int qa, int qb, float starved) {
  bool left = false;
  for (int i = threadIdx.x + ra * RF_SC; i < rb * RF_SC; i += RF_THREADS) {
    const int y = i / RF_SC, x = i % RF_SC;
    if (x < ca || x >= cb || d[y][x] > starved) continue;
    const float* rn = tn[y - 2];
    const float* rd = td[y - 2];
    const float sn =
        __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(rn[x - 2], rn[x - 1]), rn[x]), rn[x + 1]),
                  rn[x + 2]);
    const float sd =
        __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(rd[x - 2], rd[x - 1]), rd[x]), rd[x + 1]),
                  rd[x + 2]);
    n[y][x] = sn;
    d[y][x] = sd;
    left |= !(sd > starved) && y >= pa && y < pb && x >= qa && x < qb;
  }
  return left;
}

__global__ void __launch_bounds__(RF_THREADS, 4)
    refill_kernel(const float* __restrict__ num, const float* __restrict__ den,
                  float* __restrict__ out, int h, int w, long long plane, int gh, int gw,
                  int ppy, int ppx, int out_h, int out_w, int border, float starved,
                  float eps, int vec) {
  __shared__ __align__(16) float sn[RF_SR][RF_SC];
  __shared__ __align__(16) float sd[RF_SR][RF_SC];
  __shared__ __align__(16) float tn[RF_SR - 4][RF_SC];
  __shared__ __align__(16) float td[RF_SR - 4][RF_SC];
  const int ch = blockIdx.z;
  const int gy = blockIdx.y / ppy, gx = blockIdx.x / ppx;
  const int gy0 = gy * gh, gx0 = gx * gw;             // the group's first row, column
  const int gy1 = min(gy0 + gh, h), gx1 = min(gx0 + gw, w);
  const int y0 = gy0 + (blockIdx.y - gy * ppy) * RF_ROWS;
  const int x0 = gx0 + (blockIdx.x - gx * ppx) * RF_COLS;
  if (y0 >= out_h || x0 >= out_w) return;             // the piece holds no image pixel
  const int y1 = min(min(y0 + RF_ROWS, gy1), out_h);  // the piece's output rows
  const int x1 = min(min(x0 + RF_COLS, gx1), out_w);  // and columns
  const float* nb = num + ch * plane;
  const float* db = den + ch * plane;
  float* ob = out + ch * (long long)out_h * out_w;
  const int q = threadIdx.x % RF_QUADS;
  const int xq = x0 + 4 * q;
  float nv[RF_PER][4], dv[RF_PER][4];
#pragma unroll
  for (int k = 0; k < RF_PER; ++k) {
    const int y = y0 + threadIdx.x / RF_QUADS + k * RF_QROWS;
    const long long o = (long long)y * w + xq;
#pragma unroll
    for (int e = 0; e < 4; ++e) nv[k][e] = dv[k][e] = 1.0f;
    if (y >= y1 || xq >= x1) continue;
    if (vec && xq + 4 <= x1) {
      const float4 a = load_stream4(nb + o), b = load_stream4(db + o);
      nv[k][0] = a.x; nv[k][1] = a.y; nv[k][2] = a.z; nv[k][3] = a.w;
      dv[k][0] = b.x; dv[k][1] = b.y; dv[k][2] = b.z; dv[k][3] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (xq + e < x1) {
          nv[k][e] = __ldg(nb + o + e);
          dv[k][e] = __ldg(db + o + e);
        }
      }
    }
  }
  // the refill region: every pixel, or those within `border` of an edge
  auto in_region = [&](int y, int x) {
    return border < 0 || y < border || y >= h - border || x < border || x >= w - border;
  };
  // bit 4k + e: the pixel is an output pixel, starved and inside the region
  unsigned refill = 0;
#pragma unroll
  for (int k = 0; k < RF_PER; ++k) {
    const int y = y0 + threadIdx.x / RF_QUADS + k * RF_QROWS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (y < y1 && xq + e < x1 && !(dv[k][e] > starved) && in_region(y, xq + e)) {
        refill |= 1u << (4 * k + e);
      }
    }
  }
  const bool slow = __syncthreads_or(refill != 0);
  if (slow) {
    // stage the piece, zero outside the group and where den is not above
    // the threshold: from the registers, or from device memory where the
    // fast path did not load it (rows and columns of the group past the
    // crop)
#pragma unroll
    for (int k = 0; k < RF_PER; ++k) {
      const int r = threadIdx.x / RF_QUADS + k * RF_QROWS;
      const int y = y0 + r;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = xq + e;
        float a = 0.0f, b = 0.0f;
        if (y < y1 && x < x1) {
          a = nv[k][e];
          b = dv[k][e];
        } else if (y < gy1 && x < gx1) {
          const long long o = (long long)y * w + x;
          a = nb[o];
          b = db[o];
        }
        const bool good = b > starved;
        sn[RF_HALO + r][RF_HALO + 4 * q + e] = good ? a : 0.0f;
        sd[RF_HALO + r][RF_HALO + 4 * q + e] = good ? b : 0.0f;
      }
    }
  }
  float v[RF_PER][4];  // the divides; num and den are not needed past here
#pragma unroll
  for (int k = 0; k < RF_PER; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[k][e] = guarded_div(nv[k][e], dv[k][e], eps);
  }
  if (slow) {
    // the halo ring: 4 rows above and below, 4 columns on either side, its
    // loads all in flight together
    float ha[RF_RING_PER], hb[RF_RING_PER];
#pragma unroll
    for (int j = 0; j < RF_RING_PER; ++j) {
      int sy, sx;
      ring_position(threadIdx.x + j * RF_THREADS, sy, sx);
      const int y = y0 - RF_HALO + sy, x = x0 - RF_HALO + sx;
      ha[j] = hb[j] = 0.0f;
      if (sy >= 0 && y >= gy0 && y < gy1 && x >= gx0 && x < gx1) {
        const long long o = (long long)y * w + x;
        ha[j] = nb[o];
        hb[j] = db[o];
      }
    }
#pragma unroll
    for (int j = 0; j < RF_RING_PER; ++j) {
      int sy, sx;
      ring_position(threadIdx.x + j * RF_THREADS, sy, sx);
      if (sy < 0) continue;
      const bool good = hb[j] > starved;
      sn[sy][sx] = good ? ha[j] : 0.0f;
      sd[sy][sx] = good ? hb[j] : 0.0f;
    }
    __syncthreads();
    // staged rows and columns inside the group (the box sums run there),
    // and the piece's output pixels
    const int ra = max(2, gy0 - (y0 - RF_HALO)), rb = min(RF_SR - 2, gy1 - (y0 - RF_HALO));
    const int ca = max(2, gx0 - (x0 - RF_HALO)), cb = min(RF_SC - 2, gx1 - (x0 - RF_HALO));
    const int pa = RF_HALO, pb = RF_HALO + (y1 - y0);
    const int qa = RF_HALO, qb = RF_HALO + (x1 - x0);
    refill_vertical(sn, sd, tn, td, ra, rb, 0, RF_SC);
    __syncthreads();
    const bool left =
        refill_horizontal(sn, sd, tn, td, ra, rb, ca, cb, pa, pb, qa, qb, starved);
    if (__syncthreads_or(left)) {
      refill_vertical(sn, sd, tn, td, pa, pb, qa - 2, qb + 2);
      __syncthreads();
      refill_horizontal(sn, sd, tn, td, pa, pb, qa, qb, pa, pb, qa, qb, starved);
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < RF_PER; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (refill >> (4 * k + e) & 1u) {
          const int sy = RF_HALO + threadIdx.x / RF_QUADS + k * RF_QROWS;
          const int sx = RF_HALO + 4 * q + e;
          v[k][e] = guarded_div(sn[sy][sx], sd[sy][sx], eps);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RF_PER; ++k) {
    const int y = y0 + threadIdx.x / RF_QUADS + k * RF_QROWS;
    if (y >= y1 || xq >= x1) continue;
    float* p = ob + (long long)y * out_w + xq;
    if (vec && xq + 4 <= x1) {
      __stcs(reinterpret_cast<float4*>(p), make_float4(v[k][0], v[k][1], v[k][2], v[k][3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (xq + e < x1) p[e] = v[k][e];
      }
    }
  }
}

// num, den (c, h, w), rows w apart and planes `plane` apart (the same for
// both); out (c, out_h, out_w) contiguous, out_h <= h, out_w <= w; groups of
// gh x gw (the last ones cut at h, w); border: the image layout's refill
// region (< 0: everywhere). Returns a cudaError_t.
extern "C" int hmsr_refill(const float* num, const float* den, float* out, int c, int h,
                           int w, int plane, int gh, int gw, int out_h, int out_w,
                           int border, float starved, float eps, void* stream) {
  if (c < 1 || h < 1 || w < 1 || gh < 1 || gw < 1 || out_h < 1 || out_w < 1 ||
      out_h > h || out_w > w || (c > 1 && plane < (long long)h * w) || c > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int ppy = (gh + RF_ROWS - 1) / RF_ROWS, ppx = (gw + RF_COLS - 1) / RF_COLS;
  const long long gy = (long long)((h + gh - 1) / gh) * ppy;
  const long long gx = (long long)((w + gw - 1) / gw) * ppx;
  if (gy > 65535 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<size_t>(p) & 15) == 0;
  };
  const int vec = w % 4 == 0 && out_w % 4 == 0 && gw % 4 == 0 && plane % 4 == 0 &&
                  aligned(num) && aligned(den) && aligned(out);
  const dim3 grid((unsigned)gx, (unsigned)gy, c);
  refill_kernel<<<grid, RF_THREADS, 0, (cudaStream_t)stream>>>(
      num, den, out, h, w, plane, gh, gw, ppy, ppx, out_h, out_w, border, starved, eps,
      vec);
  return (int)cudaGetLastError();
}
