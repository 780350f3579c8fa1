// K1: tile block matching — exhaustive (2r+1)^2 search around round(flow).
//
// Replaces hmsr_tpu/ops/pallas_ica.py:_bm_kernel (launched by _bm_run through
// bm_pallas). Returns the integer displacement (dx, dy) of the first minimum
// per tile; the caller applies the metric's flow update (L1: round(flow)+d,
// L2: flow+d).
//   metric 0 (L1): cost sum |ref - win|, out-of-bounds pixels read 0;
//   metric 1 (L2): cost sum win^2 - 2 sum ref*win, coordinates edge-clamped.
// Each candidate's cost is summed over the tile in row-major (y, x) order,
// one rounding per __fadd_rn / __fmul_rn, as block_match_plain sums it, so
// the argmins are bit-identical to it: no tree sum inside a candidate.
//
// Bound on the H100: at Ts=16 a frame's four launches read ~200 MB once
// (0.044 ms at 3.35 TB/s); the L2 r=4 level's 244 M candidate-pixels need
// ~0.05 ms at the issue rate.
//
// What held the first design back (one block per tile, one thread per
// candidate, ~0.35 ms per frame): at L1 r=1, 55 of 64 lanes idled; each
// thread ran one dependent chain of 256 (L1) or 2 x 256 (L2) adds with
// little to hide its latency; staging used a runtime division per element;
// thread 0 scanned the costs serially between two barriers; the L2 window
// reads conflicted in shared-memory banks.
//
// This design: a thread owns one candidate row sy of one tile and carries
// its 2r+1 candidates (sx) as independent chains (L2: win^2 and ref*win
// apart, 2 x 9 at r=4). It walks the staged window row with a register
// window: each value is read from shared memory once and feeds every chain;
// its square, which every chain adds, is formed once (the same rounding).
// Tiles are packed so that every lane owns work: 2r+1 lanes per tile, as
// many tiles per warp as fit, up to four warps per block. On a level of few
// tiles (under BM_SPLIT_THREADS lanes) a candidate row at r=4 is split over
// three lanes of three chains, so that more, shorter chains run. Bands
// of 8 (r=1) or 16 (r=4) tile rows of the window and of the reference tile
// are copied into shared memory with cp.async (L1: zero-fill out of
// bounds, src-size 0; L2: clamped addresses); the shorter band at r=1
// halves the shared memory a tile holds, which bounded the warps per SM.
// The window row stride is odd and each tile's area 1 mod 32 floats,
// against bank conflicts. The argmin is a shuffle tree over the tile's
// lanes on (cost, index): a number beats NaN, a lower cost wins, an equal
// cost goes to the lower index, and a NaN first candidate wins outright,
// which is what the strict '<' scan of first_min gives on every input. (ts, r, metric) of the main paths are template parameters
// (loops unrolled); any other is the same kernel with runtime ts and r,
// which walks the candidates of a row in passes of BM_CHAINS.
#include <climits>

#include "common.cuh"

constexpr int BM_CHAINS = 9;     // candidate columns per pass of a thread
constexpr int BM_MAX_WARPS = 4;
constexpr int BM_SMEM = 48 * 1024;
// A level whose tiles x (2r+1) lanes fall under this runs with each
// candidate row split over BM_SPLIT lanes (fewer, shorter chains a thread):
// whole rows would give such a level under ~2 warps per scheduler of an
// H100. There the split was 2.2x faster at 713 tiles of 64 and even at
// 2,852 tiles of 32.
constexpr long long BM_SPLIT_THREADS = 32768;
constexpr int BM_SPLIT = 3;

struct BmTile {
  long long rbase;  // offset of the reference tile
  int top, left;    // window origin in the moving level
};

// Launch layout of (ts, r) with each candidate row over `split` lanes: P
// lanes per tile, tpw tiles per warp, `warps` warps per block; the staged
// band is `band` tile rows (8 at r <= 1, where the window adds few rows,
// else 16): (band + 2r) window rows of stride swp and band reference rows,
// `tile_floats` per tile.
struct BmLayout {
  int nc, P, tpw, warps, band, sw, swp, tile_floats, smem_bytes;
};

__host__ __device__ constexpr BmLayout bm_layout(int ts, int r, int split) {
  BmLayout L{};
  L.nc = 2 * r + 1;
  L.P = L.nc * split < 32 ? L.nc * split : 32;
  const int band = r <= 1 ? 8 : 16;
  L.band = ts < band ? ts : band;
  L.sw = ts + 2 * r;
  L.swp = L.sw | 1;
  int tf = (L.band + 2 * r) * L.swp + L.band * ts;
  tf += (33 - tf % 32) % 32;  // 1 mod 32
  L.tile_floats = tf;
  const int per_tile = 4 * tf + (int)sizeof(BmTile);
  const int fit = BM_SMEM / per_tile > 1 ? BM_SMEM / per_tile : 1;
  L.tpw = 32 / L.P < fit ? 32 / L.P : fit;
  const int w = fit / L.tpw;
  L.warps = w < 1 ? 1 : (w > BM_MAX_WARPS ? BM_MAX_WARPS : w);
  L.smem_bytes = L.warps * L.tpw * per_tile;
  return L;
}

// (c, i) ranks before (bc, bi): a number before NaN, then the lower cost,
// then the lower index.
__device__ __forceinline__ bool bm_better(float c, int i, float bc, int bi) {
  const bool cn = c != c;
  const bool bn = bc != bc;
  if (cn != bn) return bn;
  if (!cn && c != bc) return c < bc;
  return i < bi;
}

// Chains of `nck` candidates (sx0 + k) of candidate row sy over `rows` tile
// rows: wr0 is the staged window row of the band's first tile row for this
// sy, shifted by sx0; rr0 the band's first reference row.
template <int TS, int NC, int METRIC>
__device__ __forceinline__ void bm_rows_fixed(const float* wr0, int swp,
                                              const float* rr0, int rows,
                                              float* e1, float* e2) {
  for (int y = 0; y < rows; ++y) {
    const float* wr = wr0 + y * swp;
    const float* rr = rr0 + y * TS;
    float v[NC], q[NC];
#pragma unroll
    for (int k = 0; k < NC - 1; ++k) {
      v[k] = wr[k];
      if (METRIC == 1) q[k] = __fmul_rn(v[k], v[k]);
    }
#pragma unroll
    for (int x = 0; x < TS; ++x) {
      v[NC - 1] = wr[x + NC - 1];
      if (METRIC == 1) q[NC - 1] = __fmul_rn(v[NC - 1], v[NC - 1]);
      const float rv = rr[x];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        if (METRIC == 1) {
          e1[k] = __fadd_rn(e1[k], q[k]);
          e2[k] = __fadd_rn(e2[k], __fmul_rn(rv, v[k]));
        } else {
          e1[k] = __fadd_rn(e1[k], fabsf(__fsub_rn(rv, v[k])));
        }
      }
#pragma unroll
      for (int k = 0; k < NC - 1; ++k) {
        v[k] = v[k + 1];
        if (METRIC == 1) q[k] = q[k + 1];
      }
    }
  }
}

template <int METRIC>
__device__ __forceinline__ void bm_rows_generic(const float* wr0, int swp,
                                                const float* rr0, int ts,
                                                int rows, int nck, float* e1,
                                                float* e2) {
  for (int y = 0; y < rows; ++y) {
    const float* wr = wr0 + y * swp;
    const float* rr = rr0 + y * ts;
    for (int x = 0; x < ts; ++x) {
      const float rv = rr[x];
#pragma unroll
      for (int k = 0; k < BM_CHAINS; ++k) {
        if (k < nck) {
          const float v = wr[x + k];
          if (METRIC == 1) {
            e1[k] = __fadd_rn(e1[k], __fmul_rn(v, v));
            e2[k] = __fadd_rn(e2[k], __fmul_rn(rv, v));
          } else {
            e1[k] = __fadd_rn(e1[k], fabsf(__fsub_rn(rv, v)));
          }
        }
      }
    }
  }
}

// TS == 0: ts and r at run time. CPT: the chains of a thread, (2R+1) / CPT
// lanes per candidate row (fixed ts and r only).
template <int TS, int R, int METRIC, int CPT>
__global__ void __launch_bounds__(32 * BM_MAX_WARPS)
    bm_kernel(const float* __restrict__ ref, int rs0, int rs1, int rs2,
              int rs3, const float* __restrict__ mov, int h, int w,
              const float* __restrict__ flow, int ny, int nx, int ts_rt,
              int r_rt, int* __restrict__ disp) {
  constexpr bool FIXED = TS > 0;
  constexpr int NCF = FIXED ? CPT : BM_CHAINS;  // chains per pass
  constexpr int S = CPT > 0 ? (2 * R + 1) / CPT : 1;  // lanes per row
  const int ts = FIXED ? TS : ts_rt;
  const int r = FIXED ? R : r_rt;
  const BmLayout L = bm_layout(ts, r, S);
  const int nc = L.nc;
  const int NT = L.warps * L.tpw;
  extern __shared__ float4 sm4[];
  BmTile* meta = reinterpret_cast<BmTile*>(sm4);
  float* sm = reinterpret_cast<float*>(meta + NT);

  const int lane = threadIdx.x & 31;
  const int gi = lane / L.P;  // tile of the warp
  const int gs = lane - gi * L.P;
  const int tl = (threadIdx.x >> 5) * L.tpw + gi;
  const int n_tiles = ny * nx;
  const int tile = blockIdx.x * NT + tl;
  const bool live = gi < L.tpw && tile < n_tiles;

  if (threadIdx.x < NT) {
    const int t = blockIdx.x * NT + threadIdx.x;
    if (t < n_tiles) {
      const int ty = t / nx;
      const int tx = t - ty * nx;
      BmTile m;
      m.rbase = (long long)ty * rs0 + (long long)tx * rs1;
      m.top = ty * ts + __float2int_rn(flow[2 * t + 1]) - r;
      m.left = tx * ts + __float2int_rn(flow[2 * t]) - r;
      meta[threadIdx.x] = m;
    }
  }
  __syncthreads();
  const int n_live = min(NT, n_tiles - (int)blockIdx.x * NT);

  float best = __int_as_float(0x7fffffff);  // NaN: every number beats it
  int best_i = INT_MAX;
  bool first_nan = false;
  const int wrows = L.band + 2 * r;
  // lane gs takes candidate row sy0 + gs / S, columns from (gs % S) * NCF
  // (fixed ts and r: one pass; run-time: passes of L.P rows, BM_CHAINS
  // columns)
  const int sx_first = (gs % S) * NCF;
  const int sx_end = FIXED ? sx_first + NCF : nc;
  for (int sy0 = 0; sy0 < nc; sy0 += L.P / S) {
    const int sy = sy0 + gs / S;
    for (int sx0 = sx_first; sx0 < sx_end; sx0 += NCF) {
      const int nck = min(NCF, nc - sx0);
      float e1[NCF], e2[NCF];
#pragma unroll
      for (int k = 0; k < NCF; ++k) e1[k] = e2[k] = 0.0f;
      for (int y0 = 0; y0 < ts; y0 += L.band) {
        // (the instantiated ts are multiples of their band)
        const int rows = FIXED ? L.band : min(L.band, ts - y0);
        __syncthreads();  // the previous band is read
        // window rows y0 .. y0 + rows + 2r - 1 of every live tile
        const int wn = (rows + 2 * r) * L.sw;
        for (int e = threadIdx.x; e < n_live * wn; e += blockDim.x) {
          const int t = e / wn;
          const int rem = e - t * wn;
          const int a = rem / L.sw;
          const int b = rem - a * L.sw;
          const int yy = meta[t].top + y0 + a;
          const int xx = meta[t].left + b;
          float* dst = sm + t * L.tile_floats + a * L.swp + b;
          if (METRIC == 1) {
            cp_async_f32(dst, mov + (size_t)clampi(yy, 0, h - 1) * w +
                                  clampi(xx, 0, w - 1), 4);
          } else {
            const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
            cp_async_f32(dst, in ? mov + (size_t)yy * w + xx : mov, in ? 4 : 0);
          }
        }
        // reference rows y0 .. y0 + rows - 1
        const int rn = rows * ts;
        for (int e = threadIdx.x; e < n_live * rn; e += blockDim.x) {
          const int t = e / rn;
          const int rem = e - t * rn;
          const int yy = rem / ts;
          const int xx = rem - yy * ts;
          cp_async_f32(sm + t * L.tile_floats + wrows * L.swp + rem,
                       ref + meta[t].rbase + (long long)(y0 + yy) * rs2 +
                           (long long)xx * rs3, 4);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        if (live && sy < nc) {
          const float* tbuf = sm + tl * L.tile_floats;
          if constexpr (FIXED) {
            bm_rows_fixed<TS, NCF, METRIC>(tbuf + sy * L.swp + sx0, L.swp,
                                           tbuf + wrows * L.swp, rows, e1, e2);
          } else {
            bm_rows_generic<METRIC>(tbuf + sy * L.swp + sx0, L.swp,
                                    tbuf + wrows * L.swp, ts, rows, nck, e1,
                                    e2);
          }
        }
      }
      if (live && sy < nc) {
#pragma unroll
        for (int k = 0; k < NCF; ++k) {
          if (k < nck) {
            const float c =
                METRIC == 1 ? __fsub_rn(e1[k], __fmul_rn(2.0f, e2[k])) : e1[k];
            const int i = sy * nc + sx0 + k;
            if (i == 0) first_nan = c != c;
            if (bm_better(c, i, best, best_i)) {
              best = c;
              best_i = i;
            }
          }
        }
      }
    }
  }

  // the tile's best over its P lanes
  for (int off = 1; off < L.P; off <<= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (gs + off < L.P && bm_better(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (live && gs == 0) {
    const int i = first_nan ? 0 : best_i;
    disp[2 * tile] = i % nc - r;
    disp[2 * tile + 1] = i / nc - r;
  }
}

template <int TS, int R, int METRIC, int CPT>
static int launch_bm(const float* ref, int rs0, int rs1, int rs2, int rs3,
                     const float* mov, int h, int w, const float* flow, int ny,
                     int nx, int ts, int r, int* disp, cudaStream_t stream) {
  const BmLayout L = bm_layout(ts, r, CPT > 0 ? (2 * R + 1) / CPT : 1);
  auto kernel = bm_kernel<TS, R, METRIC, CPT>;
  if (L.smem_bytes > BM_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int NT = L.warps * L.tpw;
  if (ny > 0 && nx > 0) {
    kernel<<<(ny * nx + NT - 1) / NT, 32 * L.warps, L.smem_bytes, stream>>>(
        ref, rs0, rs1, rs2, rs3, mov, h, w, flow, ny, nx, ts, r, disp);
  }
  return (int)cudaGetLastError();
}

// (ts, r, metric) with instantiations of their own: the levels of the main
// paths at Ts = 16, 32 and 64.
#define BM_FIXED_LEVELS(X) \
  X(8, 4, 1) X(16, 4, 1) X(32, 4, 1) X(64, 4, 1) X(16, 1, 0) X(32, 1, 0) X(64, 1, 0)

static bool bm_fixed(int ts, int r, int metric) {
#define BM_IS(TS_, R_, M_) || (ts == TS_ && r == R_ && metric == M_)
  return false BM_FIXED_LEVELS(BM_IS);
#undef BM_IS
}

// Whether a level of n_tiles splits its candidate rows (r = 4 only:
// BM_SPLIT lanes of 3 chains).
static int bm_split(int ts, int r, int metric, long long n_tiles) {
  return bm_fixed(ts, r, metric) && r == 4 &&
                 n_tiles * (2 * r + 1) < BM_SPLIT_THREADS
             ? BM_SPLIT
             : 1;
}

extern "C" int hmsr_block_match(const float* ref, int rs0, int rs1, int rs2,
                                int rs3, const float* mov, int h, int w,
                                const float* flow, int ny, int nx, int ts,
                                int r, int metric, int* disp, void* stream) {
  if (ts < 1 || r < 0 || (metric != 0 && metric != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int split = bm_split(ts, r, metric, (long long)ny * nx);
#define BM_ARGS ref, rs0, rs1, rs2, rs3, mov, h, w, flow, ny, nx, ts, r, disp, s
// each fixed level whole (CPT = 2r+1) and, at r = 4, split (CPT = 3)
#define BM_CASE(TS_, R_, M_)                                            \
  if (ts == TS_ && r == R_ && metric == M_)                             \
    return split == 1                                                   \
               ? launch_bm<TS_, R_, M_, 2 * R_ + 1>(BM_ARGS)            \
               : launch_bm<TS_, R_, M_, (R_ == 4 ? (2 * R_ + 1) / BM_SPLIT \
                                                 : 2 * R_ + 1)>(BM_ARGS);
  BM_FIXED_LEVELS(BM_CASE)
  return metric == 1 ? launch_bm<0, 0, 1, 0>(BM_ARGS)
                     : launch_bm<0, 0, 0, 0>(BM_ARGS);
#undef BM_CASE
#undef BM_ARGS
}

// The launch layout of (ts, r, metric) on a level of n_tiles tiles: out[0]
// 1 for an instantiation of its own, 0 for the run-time one; out[1] tiles
// per warp, out[2] lanes per tile, out[3] threads per block, out[4] tile
// rows per staged band, out[5] dynamic shared memory bytes.
extern "C" int hmsr_bm_layout(int ts, int r, int metric, int n_tiles,
                              int* out) {
  if (ts < 1 || r < 0 || (metric != 0 && metric != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const BmLayout L = bm_layout(ts, r, bm_split(ts, r, metric, n_tiles));
  out[0] = bm_fixed(ts, r, metric) ? 1 : 0;
  out[1] = L.tpw;
  out[2] = L.P;
  out[3] = 32 * L.warps;
  out[4] = L.band;
  out[5] = L.smem_bytes;
  return 0;
}
