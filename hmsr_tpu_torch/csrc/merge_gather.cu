// K11: the gather merge of one compared frame (Alg. 4) at any scale, into
// (num, den) in place.
//
// Replaces no TPU kernel: the JAX package runs this merge as XLA
// (hmsr_tpu/models/merge.py:85 merge), and the port ran it as plain torch in
// bands of HR rows, about 600 elementwise launches a band
// (ops/cuda_merge.py:gather_merge_plain, now its plain version and the CPU
// path). It is the merge of every compared frame whose merge is not tiled:
// the scan form at a fractional scale, tpu.merge_impl: gather at
// an integer one, and the sharded pipeline's bands of HR rows (row_offset).
// All four variants: Bayer or grey mode (G = 2, 1) times the steerable or the
// isotropic kernel (ISO = 0, 1), each an instantiation
// gather_merge_kernel<G, ISO>.
//
// Conventions (models/merge.py's docstring), each in the plain version's
// order of operations, so that under the library's -fmad=false the kernel
// equals gather_merge_plain on the card bit for bit: the LR position of HR
// pixel hr is (hr + 0.5) / s, an IEEE division; its flow tile is PyTorch's
// float floor division lr // Ts (torch_floordiv), clipped to the flow grid;
// robustness is read nearest at min(int(lr), size - 1); a warped centre
// outside the frame has weight 0; the covariance is interpolated at
// lr_mov / 2 - 0.5 (Bayer) or lr_mov - 0.5 (grey) with truncation, signed
// fractions and clamped indices, and inverted without a guard (1 / det);
// the 3x3 taps are centred on int(lr_mov), their distances taken to
// lr_mov - 0.5, a tap outside the frame has weight 0; the weight is
// expf(-0.5 max(0, z)) with z's NaN kept, as torch.clamp keeps it. The
// taps are summed in the plain version's order (rows, then columns) and
// added to num/den once. A NaN weight (a singular covariance) reaches every
// channel, as the plain version's masked products carry it.
//
// Bound on the H100: bytes. Per HR pixel a read-modify-write of the
// accumulators, 6 floats in Bayer mode and 2 in grey mode: 48 bytes, 1.30 GB
// a frame at 4500x6000 (x1.5 of 3000x4000), 0.39 ms at 3.35 TB/s. The
// inputs, each read about once from device memory (the frame, robustness,
// the covariances, the flow), add 0.13 GB, 0.04 ms. The arithmetic that
// varies per pixel (the covariance interpolation and inverse, 9 quadratic
// forms and IEEE expf, the accumulation) is some 300 instructions.
//
// Design: one block of GM_THREADS threads per GM_TH x GM_TW HR pixels
// (16 rows x 64 columns), GM_PPT pixels a thread, a thread's pixels in one
// column. Neighbouring threads take neighbouring HR columns, so each warp's
// accumulator traffic is 128 contiguous bytes a plane; a thread owns its
// num/den entries (no atomics) and loads them before anything else, so
// that their latency overlaps the tables. The row and column terms
// separate: the LR coordinate, the flow tile and the robustness index of
// each of the block's 16 rows and 64 columns are computed once into
// shared-memory tables (the floor division is ~20 instructions), not once
// a pixel. The frame, robustness, covariance and flow reads go through the
// read-only path (__ldg): a block's footprint in them is a few KB (at x1.5,
// ~45 x 13 raw pixels and ~23 x 7 covariances), read by neighbouring
// threads at neighbouring addresses, so after a warp's first touch they are
// L1 hits and device memory serves each about once.
//
// Measured (edited copies of this file timed side by side on one H100 80GB
// HBM3 at 700 W, 3000x4000 to x1.5, Bayer steerable): 0.82 ms, 1.9x the
// byte bound. Without the accumulator traffic 0.67 ms: the per-pixel work,
// not the bytes, sets the pace. Without the frame, covariance and
// robustness reads 0.60 ms (without the frame's alone 0.72, the
// covariances' alone 0.75): those 22 L1-served loads a pixel are the 28 %
// that staging could at most save. Windows staged with cp.async and sized
// from the block's flow range would replace them by as many shared-memory
// loads, plus a staging pass and a data-dependent shared-memory size, so
// the read-only path stays. Layouts: 16 x 64 pixels a block 0.82 ms,
// 8 x 128 0.82, 8 x 64 0.86 (48 registers), 32 x 64 1.00 (128 registers),
// 16 x 64 held to 64 registers 0.87 (spills).
#include "common.cuh"

constexpr int GM_THREADS = 256;
constexpr int GM_TW = 64;  // HR columns of a block
constexpr int GM_TH = 16;  // HR rows of a block
constexpr int GM_PPT = GM_TW * GM_TH / GM_THREADS;

// PyTorch's float floor division (c10/util/generic_math.h,
// div_floor_floating), step for step: torch.div(a, b, rounding_mode="floor")
// on the card and on the CPU.
__device__ __forceinline__ float torch_floordiv(float a, float b) {
  if (b == 0.0f) return a / b;
  const float mod = fmodf(a, b);
  float div = (a - mod) / b;
  if (mod != 0.0f && (b < 0.0f) != (mod < 0.0f)) div -= 1.0f;
  if (div == 0.0f) return copysignf(0.0f, a / b);
  float fl = floorf(div);
  if (div - fl > 0.5f) fl += 1.0f;
  return fl;
}

// An HR row's or column's terms: its LR coordinate, its flow tile clipped to
// [0, nt - 1] and its robustness index min(int(lr), n - 1).
struct GatherAxis {
  float lr;
  int tile;
  int rob;
};

__device__ __forceinline__ GatherAxis gather_axis(int hr, float s, float ts,
                                                  int nt, int n) {
  GatherAxis a;
  a.lr = ((float)hr + 0.5f) / s;
  a.tile = clampi(__float2int_rz(torch_floordiv(a.lr, ts)), 0, nt - 1);
  a.rob = min(__float2int_rz(a.lr), n - 1);
  return a;
}

template <int G, int ISO>
__global__ void __launch_bounds__(GM_THREADS)
    gather_merge_kernel(const float* __restrict__ comp, int H, int W,
                        const float* __restrict__ flow, int fh, int fw,
                        const float* __restrict__ covs, int gh, int gw,
                        const float* __restrict__ rob, float* __restrict__ num,
                        float* __restrict__ den, int acc_h, int out_w,
                        int row_offset, float s, float ts, MergeCfa cfa) {
  constexpr int NCH = G == 2 ? 3 : 1;
  __shared__ GatherAxis rowt[GM_TH], colt[GM_TW];
  const int y0 = blockIdx.y * GM_TH, x0 = blockIdx.x * GM_TW;
  const size_t plane = (size_t)acc_h * out_w;
  // the thread's accumulators, loaded first
  float n[GM_PPT][NCH], d[GM_PPT][NCH];
#pragma unroll
  for (int k = 0; k < GM_PPT; ++k) {
    const int p = threadIdx.x + k * GM_THREADS;
    const int y = y0 + p / GM_TW, x = x0 + p % GM_TW;
    const bool in = y < acc_h && x < out_w;
    const size_t o = (size_t)y * out_w + x;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      n[k][ch] = in ? num[ch * plane + o] : 0.0f;
      d[k][ch] = in ? den[ch * plane + o] : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < GM_TH + GM_TW; i += GM_THREADS) {
    if (i < GM_TH) {
      rowt[i] = gather_axis(row_offset + y0 + i, s, ts, fh, H);
    } else {
      colt[i - GM_TH] = gather_axis(x0 + i - GM_TH, s, ts, fw, W);
    }
  }
  __syncthreads();

  const float2* fl = reinterpret_cast<const float2*>(flow);
  const size_t cplane = (size_t)gh * gw;
#pragma unroll
  for (int k = 0; k < GM_PPT; ++k) {
    const int p = threadIdx.x + k * GM_THREADS;
    const int ly = p / GM_TW, lx = p % GM_TW;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= acc_h || x >= out_w) continue;
    const GatherAxis ay = rowt[ly], ax = colt[lx];
    const float2 f = __ldg(fl + ay.tile * fw + ax.tile);
    const float lmx = ax.lr + f.x, lmy = ay.lr + f.y;
    const bool inbound = lmx >= 0.0f && lmx < (float)W && lmy >= 0.0f &&
                         lmy < (float)H;

    // ---- steerable: the covariance at the warped position, inverted
    float ixx = 0.0f, ixy2 = 0.0f, iyy = 0.0f;
    if (!ISO) {
      const float kx = G == 2 ? lmx / 2.0f - 0.5f : lmx - 0.5f;
      const float ky = G == 2 ? lmy / 2.0f - 0.5f : lmy - 0.5f;
      const float tx = truncf(kx), ty = truncf(ky);
      const float frx = kx - tx, fry = ky - ty;
      const int cx0 = clampi(__float2int_rz(tx), 0, gw - 1);
      const int cy0 = clampi(__float2int_rz(ty), 0, gh - 1);
      const int cx1 = min(cx0 + 1, gw - 1), cy1 = min(cy0 + 1, gh - 1);
      float cc[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* cv = covs + c * cplane;
        const float tr = __ldg(cv + (size_t)cy0 * gw + cx0);
        const float tl = __ldg(cv + (size_t)cy0 * gw + cx1);
        const float br = __ldg(cv + (size_t)cy1 * gw + cx0);
        const float bl = __ldg(cv + (size_t)cy1 * gw + cx1);
        const float top = tr + frx * (tl - tr);
        const float bot = br + frx * (bl - br);
        cc[c] = top + fry * (bot - top);
      }
      const float inv_det = 1.0f / (cc[0] * cc[2] - cc[1] * cc[1]);
      ixx = inv_det * cc[2];
      ixy2 = 2.0f * (-inv_det * cc[1]);
      iyy = inv_det * cc[0];
    }

    // ---- the 3x3 taps. A column's terms of the quadratic form are taken
    // once for its three rows: (ixx dx) dx and (2 ixy) dx, as the plain
    // version's products run.
    const int ci = __float2int_rz(lmy), cj = __float2int_rz(lmx);
    const float drx = lmx - 0.5f, dry = lmy - 0.5f;
    const float wr = inbound ? __ldg(rob + (size_t)ay.rob * W + ax.rob) : 0.0f;
    int m = 0;
    if (G == 2) {
      const int pq = 2 * (ci & 1) + (cj & 1);
      m = pq == 0 ? cfa.m[0]
                  : (pq == 1 ? cfa.m[1] : (pq == 2 ? cfa.m[2] : cfa.m[3]));
    }
    float dx[3], qx[3], px[3];
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) {
      dx[dj] = (float)(cj + dj - 1) - drx;
      qx[dj] = ISO ? dx[dj] * dx[dj] : ixx * dx[dj] * dx[dj];
      px[dj] = ixy2 * dx[dj];
    }
    float v[NCH], a[NCH];
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) v[ch] = a[ch] = 0.0f;
#pragma unroll
    for (int di = 0; di < 3; ++di) {
      const int i = ci + di - 1;
      const bool in_i = i >= 0 && i < H;
      const float dy = (float)i - dry;
      const float qy = ISO ? dy * dy : iyy * dy * dy;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const int j = cj + dj - 1;
        const bool inb = in_i && j >= 0 && j < W;
        float z = ISO ? 2.0f * (qx[dj] + qy) : (qx[dj] + px[dj] * dy) + qy;
        z = z < 0.0f ? 0.0f : z;
        const float w = expf(-0.5f * z) * wr * (inb ? 1.0f : 0.0f);
        const float wc = w * (inb ? __ldg(comp + (size_t)i * W + j) : 0.0f);
        if (G == 2) {
          const bool nan = w != w;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            if (((m >> (9 * ch + 3 * di + dj)) & 1) || nan) {
              v[ch] += wc;
              a[ch] += w;
            }
          }
        } else {
          v[0] += wc;
          a[0] += w;
        }
      }
    }
    const size_t o = (size_t)y * out_w + x;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      num[ch * plane + o] = n[k][ch] + v[ch];
      den[ch * plane + o] = d[k][ch] + a[ch];
    }
  }
}

// The launch of hmsr_gather_merge, one instantiation per variant.
struct GatherMergeLaunch {
  const float* comp;
  int H, W;
  const float* flow;
  int fh, fw;
  const float* covs;
  int gh, gw;
  const float* rob;
  float* num;
  float* den;
  int acc_h, out_w, row_offset;
  float s, ts;
  int cfa;
  cudaStream_t stream;

  template <int G, int ISO>
  int run() {
    const dim3 grid((out_w + GM_TW - 1) / GM_TW, (acc_h + GM_TH - 1) / GM_TH);
    gather_merge_kernel<G, ISO><<<grid, GM_THREADS, 0, stream>>>(
        comp, H, W, flow, fh, fw, covs, gh, gw, rob, num, den, acc_h, out_w,
        row_offset, s, ts, merge_cfa_masks(cfa));
    return (int)cudaGetLastError();
  }
};

// One compared frame's gather merge. comp, rob: (H, W); flow: (fh, fw, 2) per
// raw tile of ts pixels; covs: (3, gh, gw) on the grey grid (Bayer) or the
// raw grid (grey), unread with iso; num, den: (c, acc_h, out_w) holding
// global HR rows row_offset .. of the image at scale s, every one evaluated.
// cfa: the 2x2 pattern packed as in merge_cfa_masks (Bayer only).
extern "C" int hmsr_gather_merge(const float* comp, int H, int W,
                                 const float* flow, int fh, int fw,
                                 const float* covs, int gh, int gw,
                                 const float* rob, float* num, float* den,
                                 int acc_h, int out_w, int row_offset, float s,
                                 float ts, int cfa, int grey, int iso,
                                 void* stream) {
  if (acc_h <= 0 || out_w <= 0) return (int)cudaGetLastError();
  if (H <= 0 || W <= 0 || fh <= 0 || fw <= 0 || row_offset < 0 ||
      acc_h > 65535 * GM_TH || !(s > 0.0f) || !(ts > 0.0f)) {
    return (int)cudaErrorInvalidValue;
  }
  GatherMergeLaunch launch{comp, H,    W,     flow,       fh, fw,  covs,
                           gh,   gw,   rob,   num,        den, acc_h, out_w,
                           row_offset, s, ts, cfa, (cudaStream_t)stream};
  return merge_dispatch(grey, iso, launch);
}

__global__ void gather_positions_kernel(const int* __restrict__ hr, int n,
                                        float s, float ts, int nt, int size,
                                        float* lr, int* tile, int* rob) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const GatherAxis a = gather_axis(hr[i], s, ts, nt, size);
  lr[i] = a.lr;
  tile[i] = a.tile;
  rob[i] = a.rob;
}

// K11's terms of n HR coordinates hr (a row's or a column's): the LR
// coordinate, the flow tile clipped to [0, nt - 1] and the robustness index
// clipped to size - 1, as gather_merge_kernel computes them.
extern "C" int hmsr_gather_positions(const int* hr, int n, float s, float ts,
                                     int nt, int size, float* lr, int* tile,
                                     int* rob, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (nt <= 0 || size <= 0 || !(s > 0.0f) || !(ts > 0.0f)) {
    return (int)cudaErrorInvalidValue;
  }
  gather_positions_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      hr, n, s, ts, nt, size, lr, tile, rob);
  return (int)cudaGetLastError();
}
