// K12: the merge kernels' covariances of one frame (Alg. 5) in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (hmsr_tpu/models/kernels.py:52 estimate_kernels), and the port ran it as
// plain torch, about 150 launches a frame, each a full pass over a grey-grid
// map (ops/cuda_estimate.py:estimate_kernels_plain, now its plain version and
// the CPU path). Semantics of the plain version, from the raw float32 frame
// (H, W) to the (3, gh, gw) covariances (xx, xy, yy), gh x gw = H/2 x W/2
// (floor: an odd last row or column is cropped) in Bayer mode and H x W in
// grey mode:
//   - the variance-stabilising transform (ops/gat.py) of every raw pixel,
//     2/alpha sqrt(max(alpha I + 3/8 alpha^2 + beta, 0)), its root correctly
//     rounded (the plain version's float64 root rounded once is that value:
//     53 >= 2 * 24 + 2);
//   - Bayer only, the 2x2 mean of each quad, ((q00 + q01) + q10) + q11 times
//     1/4 (ops/grey.py:decimate_to_grey);
//   - the half-pixel gradients on the (gh - 1, gw - 1) grid
//     (ops/gradients.py), their products gx^2, gx gy, gy^2, zero-padded by one
//     on every side, and the 2x2 window sums of those, ((p00 + p01) + p10) +
//     p11, at every grey pixel: the structure tensor;
//   - its eigen-decomposition (ops/linalg2x2.py:eigen_2x2, with its
//     axis-aligned cases v0 == 0, v1 == 0, its identity case m01 == 0 &
//     m00 == m11 and its sign rule), the anisotropy A = 1 + sqrt(max(l1 - l2,
//     0) / tr) where tr > 0, the denoise term D, the stretch and shrink k1, k2
//     of the selection law (LAW 0: the hard threshold A > 1.95; 1: linear),
//     and the covariances k1^2 e1 e1^T + k2^2 e2 e2^T.
// Every float is computed with the plain version's operations in its order on
// the card: -fmad=false, IEEE division and correctly rounded roots; a division
// by a Python number is PyTorch's multiply by the float32 reciprocal (/ D_tr,
// / 2, / 4); each Python constant is folded in double and rounded to float32
// by the wrapper, as PyTorch rounds it at its op; a clamp passes a NaN, as
// torch.clamp does. So the covariances are the plain version's bit for bit on
// the card, and every threshold of the chain falls on the same side.
//
// Bound on the H100: device memory. A 12 MP frame (3000 x 4000) is read once
// (48 MB) and the covariances written once: 36 MB in Bayer mode (3 x 1500 x
// 2000), 144 MB in grey mode; 0.025 and 0.057 ms at 3.35 TB/s. The
// arithmetic, some 200 instructions a grey pixel (three IEEE divisions, four
// correctly rounded roots, and the transform's root of each raw pixel), is
// of the same order on 132 SMs, so the design keeps every intermediate on
// chip and every pass over memory single.
//
// Design: one block of ES_THREADS threads owns ES_TY x ES_TX grey pixels
// (32 x 32) and works in three phases, each a loop strided by blockDim.x (so
// that the kernel's logic also runs with one thread a block). (1) The grey
// tile and a halo of one grey pixel on each side (two raw pixels in Bayer
// mode) into shared memory: each raw pixel of the tile is read once through
// the read-only path, its transform taken and its quad averaged; pixels
// outside the grey grid are 0 (no valid gradient reads them). A thread
// issues the loads of ES_UNROLL grey pixels before it transforms any, so
// that their latency overlaps. (2) The gradient products at the tile's
// (ES_TY + 1) x (ES_TX + 1) gradient positions into shared memory, zero
// outside the gradient grid (the plain version's padding). (3) Per grey
// pixel the window sums and the chain in registers; a warp takes one row of
// 32 pixels, so each plane's store is 128 contiguous bytes (whole sectors)
// and the shared-memory reads are conflict-free. A block whose tile and
// halo lie inside the grid (all but the grid's edge blocks) takes the three
// phases without their bounds tests. Static shared memory (17.7 KB) and at
// most 32 registers: 8 blocks, 2,048 threads, on each SM; no attribute to
// set, no per-shape state. Bayer or grey and the selection law are the
// template parameters (estimate_kernel<BAYER, LAW>); the constants are
// run-time arguments.
//
// Measured (edited copies of this file timed side by side on one H100 80GB
// HBM3 at 700 W, 3000x4000, the linear law, Bayer / grey): this design
// 0.0499 / 0.1358 ms, 1.99x / 2.37x the byte bound. Without the unrolled
// loads 0.0510 / 0.1400; without the bounds-free inner blocks as well
// 0.0536 / 0.1498. A 32 x 64 tile whose threads walk down 8 rows each,
// keeping the gradient row above in registers (half the shared-memory
// reads, 46 registers, 5 blocks an SM): 0.0522 / 0.1365, and 0.0561 /
// 0.1357 held to 40 registers; the walk on a 32 x 32 or 16 x 64 tile held
// to 32 registers spills. The chain's ~180 instructions a pixel (four
// correctly rounded roots, three IEEE divisions, each with its slow-path
// test) set the pace in grey mode, where every raw pixel is a grey pixel.
#include <cuda_runtime.h>

constexpr int ES_THREADS = 256;
constexpr int ES_TY = 32;                                 // grey rows a block
constexpr int ES_TX = 32;                                 // grey columns a block
constexpr int ES_UNROLL = 3;                              // grey pixels a step stages
constexpr int ES_GR = ES_TY + 2, ES_GC = ES_TX + 2;       // grey tile and halo
constexpr int ES_PR = ES_TY + 1, ES_PC = ES_TX + 1;       // gradient positions

// The chain's Python constants, each folded in double and rounded to float32
// by the wrapper (ops/cuda_estimate.py:estimate_params).
struct EstimateParams {
  float alpha, vst_add, beta, vst_scale;  // alpha, 3/8 alpha^2, beta, 2 / alpha
  float inv_dtr, d_th, k_detail, k_denoise;  // float32(1) / float32(D_tr), ...
  float k1, k2;  // LAW 0: 1 / k_shrink, k_stretch; LAW 1: 1 / k_shrink - 1, k_stretch - 1
};

// torch.clamp's: a NaN passes.
__device__ __forceinline__ float es_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float es_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float es_vst(float x, const EstimateParams& p) {
  float v = p.alpha * x;
  v = v + p.vst_add;
  v = v + p.beta;
  return p.vst_scale * __fsqrt_rn(es_clamp_min(v, 0.0f));
}

// The covariances (c00, c01, c11) of one structure tensor (s00, s01, s11).
template <int LAW>
__device__ __forceinline__ void es_pixel(float s00, float s01, float s11,
                                         const EstimateParams& p, float& c00, float& c01,
                                         float& c11) {
  // eigen_2x2(s00, s01, s01, s11): the roots of X^2 + b X + c, larger first
  const float b = -(s00 + s11);
  const float c = s00 * s11 - s01 * s01;
  const float sq = __fsqrt_rn(es_clamp_min(b * b - 4.0f * c, 0.0f));
  const float r1 = (-b + sq) * 0.5f;
  const float r2 = (-b - sq) * 0.5f;
  const bool big_first = fabsf(r1) >= fabsf(r2);
  const float l1 = big_first ? r1 : r2;
  const float l2 = big_first ? r2 : r1;
  const float v0 = (s00 + s01) - l2;
  const float v1 = (s01 + s11) - l2;
  const float norm = __fsqrt_rn(v0 * v0 + v1 * v1);
  const float safe_norm = norm > 0.0f ? norm : 1.0f;
  const float n0 = __fdiv_rn(v0, safe_norm);
  const float n1 = __fdiv_rn(v1, safe_norm);
  // torch.sign (a NaN gives 0) plus (n0 == 0): copysign(1, n0), +0 -> +1
  const float sign = (float)((0.0f < n0) - (n0 < 0.0f)) + (n0 == 0.0f ? 1.0f : 0.0f);
  float e10 = n0, e11 = n1, e20 = -n1 * sign, e21 = fabsf(n0);
  if (v0 == 0.0f) {
    e10 = 0.0f; e11 = 1.0f; e20 = 1.0f; e21 = 0.0f;
  } else if (v1 == 0.0f) {
    e10 = 1.0f; e11 = 0.0f; e20 = 0.0f; e21 = 1.0f;
  }
  if (s01 == 0.0f && s00 == s11) {
    e10 = 1.0f; e11 = 0.0f; e20 = 0.0f; e21 = 1.0f;
  }

  // models/kernels.py:_compute_k
  const float tr = l1 + l2;
  const bool pos = tr > 0.0f;
  const float safe_tr = pos ? tr : 1.0f;
  const float A =
      pos ? 1.0f + __fsqrt_rn(__fdiv_rn(es_clamp_min(l1 - l2, 0.0f), safe_tr)) : 1.0f;
  const float D = es_clamp(
      (1.0f - __fsqrt_rn(es_clamp_min(l1, 0.0f)) * p.inv_dtr) + p.d_th, 0.0f, 1.0f);
  float k1, k2;
  if (LAW == 1) {
    const float half_a = A * 0.5f;
    k1 = 1.0f + half_a * p.k1;
    k2 = 1.0f + half_a * p.k2;
  } else {
    const bool aniso = A > 1.95f;
    k1 = aniso ? p.k1 : 1.0f;
    k2 = aniso ? p.k2 : 1.0f;
  }
  const float one_d = 1.0f - D;
  const float dk = D * p.k_denoise;
  const float kk1 = p.k_detail * (one_d * k1 + dk);
  const float kk2 = p.k_detail * (one_d * k2 + dk);
  const float k1_sq = kk1 * kk1, k2_sq = kk2 * kk2;
  c00 = (k1_sq * e10) * e10 + (k2_sq * e20) * e20;
  c01 = (k1_sq * e10) * e11 + (k2_sq * e20) * e21;
  c11 = (k1_sq * e11) * e11 + (k2_sq * e21) * e21;
}

// (1) grey (i0 - 1 .., j0 - 1 ..) into `grey`; CHECK: some of it lies outside
// the grid.
template <int BAYER, bool CHECK>
__device__ __forceinline__ void es_stage(const float* __restrict__ raw, int rw, int gh,
                                         int gw, int i0, int j0, const EstimateParams& p,
                                         float* grey) {
  constexpr int N = ES_GR * ES_GC;
  constexpr int Q = BAYER ? 4 : 1;  // raw pixels a grey pixel
  for (int e0 = threadIdx.x; e0 < N; e0 += ES_UNROLL * blockDim.x) {
    float v[ES_UNROLL][Q];
    bool in[ES_UNROLL];
#pragma unroll
    for (int u = 0; u < ES_UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      const int r = e / ES_GC, c = e - r * ES_GC;
      const int y = i0 - 1 + r, x = j0 - 1 + c;
      in[u] = e < N && (!CHECK || (y >= 0 && y < gh && x >= 0 && x < gw));
      if (in[u]) {
        const float* q = raw + (size_t)(BAYER ? 2 * y : y) * rw + (BAYER ? 2 * x : x);
        v[u][0] = __ldg(q);
        if (BAYER) {
          v[u][Q > 1 ? 1 : 0] = __ldg(q + 1);
          v[u][Q > 1 ? 2 : 0] = __ldg(q + rw);
          v[u][Q > 1 ? 3 : 0] = __ldg(q + rw + 1);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ES_UNROLL; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e >= N) break;
      float g = 0.0f;
      if (in[u]) {
        if (BAYER) {
          g = (((es_vst(v[u][0], p) + es_vst(v[u][Q > 1 ? 1 : 0], p)) +
                es_vst(v[u][Q > 1 ? 2 : 0], p)) + es_vst(v[u][Q > 1 ? 3 : 0], p)) * 0.25f;
        } else {
          g = es_vst(v[u][0], p);
        }
      }
      grey[e] = g;
    }
  }
}

// (2) gradient position (y, x) reads grey (y .. y + 1, x .. x + 1)
template <bool CHECK>
__device__ __forceinline__ void es_products(int gh, int gw, int i0, int j0,
                                            const float* grey, float* pxx, float* pxy,
                                            float* pyy) {
  for (int e = threadIdx.x; e < ES_PR * ES_PC; e += blockDim.x) {
    const int r = e / ES_PC, c = e - r * ES_PC;
    const int y = i0 - 1 + r, x = j0 - 1 + c;
    float xx = 0.0f, xy = 0.0f, yy = 0.0f;
    if (!CHECK || (y >= 0 && y < gh - 1 && x >= 0 && x < gw - 1)) {
      const float* t = grey + r * ES_GC + c;
      const float g00 = t[0], g01 = t[1], g10 = t[ES_GC], g11 = t[ES_GC + 1];
      const float gx = 0.5f * (0.5f * (g01 - g00) + 0.5f * (g11 - g10));
      const float gy = 0.5f * (0.5f * (g11 + g10) - 0.5f * (g01 + g00));
      xx = gx * gx;
      xy = gx * gy;
      yy = gy * gy;
    }
    pxx[e] = xx;
    pxy[e] = xy;
    pyy[e] = yy;
  }
}

// (3) grey pixel (i, j) sums the gradient positions (i - 1 .. i, j - 1 .. j)
template <int LAW, bool CHECK>
__device__ __forceinline__ void es_outputs(int gh, int gw, int i0, int j0,
                                           const EstimateParams& p, const float* pxx,
                                           const float* pxy, const float* pyy,
                                           float* __restrict__ out) {
  const size_t plane = (size_t)gh * gw;
  for (int e = threadIdx.x; e < ES_TY * ES_TX; e += blockDim.x) {
    const int r = e / ES_TX, c = e - r * ES_TX;
    const int i = i0 + r, j = j0 + c;
    if (CHECK && (i >= gh || j >= gw)) continue;
    const int k = r * ES_PC + c;
    const float s00 = ((pxx[k] + pxx[k + 1]) + pxx[k + ES_PC]) + pxx[k + ES_PC + 1];
    const float s01 = ((pxy[k] + pxy[k + 1]) + pxy[k + ES_PC]) + pxy[k + ES_PC + 1];
    const float s11 = ((pyy[k] + pyy[k + 1]) + pyy[k + ES_PC]) + pyy[k + ES_PC + 1];
    float c00, c01, c11;
    es_pixel<LAW>(s00, s01, s11, p, c00, c01, c11);
    const size_t o = (size_t)i * gw + j;
    out[o] = c00;
    out[plane + o] = c01;
    out[2 * plane + o] = c11;
  }
}

template <int BAYER, int LAW>
__global__ void __launch_bounds__(ES_THREADS, 8)
estimate_kernel(const float* __restrict__ raw, int rw, int gh, int gw, EstimateParams p,
                float* __restrict__ out) {
  __shared__ float grey[ES_GR * ES_GC];
  __shared__ float pxx[ES_PR * ES_PC], pxy[ES_PR * ES_PC], pyy[ES_PR * ES_PC];
  const int i0 = blockIdx.y * ES_TY, j0 = blockIdx.x * ES_TX;
  // the tile and its halo inside the grid: no bounds to test
  if (i0 >= 1 && j0 >= 1 && i0 + ES_TY <= gh - 1 && j0 + ES_TX <= gw - 1) {
    es_stage<BAYER, false>(raw, rw, gh, gw, i0, j0, p, grey);
    __syncthreads();
    es_products<false>(gh, gw, i0, j0, grey, pxx, pxy, pyy);
    __syncthreads();
    es_outputs<LAW, false>(gh, gw, i0, j0, p, pxx, pxy, pyy, out);
  } else {
    es_stage<BAYER, true>(raw, rw, gh, gw, i0, j0, p, grey);
    __syncthreads();
    es_products<true>(gh, gw, i0, j0, grey, pxx, pxy, pyy);
    __syncthreads();
    es_outputs<LAW, true>(gh, gw, i0, j0, p, pxx, pxy, pyy, out);
  }
}

template <int BAYER, int LAW>
static void launch_estimate(const float* raw, int rw, int gh, int gw,
                            const EstimateParams& p, float* out, cudaStream_t s) {
  const dim3 grid((gw + ES_TX - 1) / ES_TX, (gh + ES_TY - 1) / ES_TY);
  estimate_kernel<BAYER, LAW><<<grid, ES_THREADS, 0, s>>>(raw, rw, gh, gw, p, out);
}

// K12: raw (rh, rw) float32, contiguous; out (3, gh, gw) float32, contiguous,
// gh x gw = rh/2 x rw/2 (bayer = 1) or rh x rw (bayer = 0); law 0 the hard
// threshold, 1 linear, with (k1, k2) as EstimateParams has them.
extern "C" int hmsr_estimate(const float* raw, int rh, int rw, int bayer, int law,
                             float alpha, float vst_add, float beta, float vst_scale,
                             float inv_dtr, float d_th, float k_detail, float k_denoise,
                             float k1, float k2, float* out, void* stream) {
  const int gh = bayer ? rh / 2 : rh, gw = bayer ? rw / 2 : rw;
  if (gh <= 0 || gw <= 0 || (law != 0 && law != 1) ||
      (gh + ES_TY - 1) / ES_TY > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const EstimateParams p = {alpha, vst_add, beta, vst_scale, inv_dtr,
                            d_th,  k_detail, k_denoise, k1, k2};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bayer) {
    if (law) launch_estimate<1, 1>(raw, rw, gh, gw, p, out, s);
    else launch_estimate<1, 0>(raw, rw, gh, gw, p, out, s);
  } else {
    if (law) launch_estimate<0, 1>(raw, rw, gh, gw, p, out, s);
    else launch_estimate<0, 0>(raw, rw, gh, gw, p, out, s);
  }
  return (int)cudaGetLastError();
}
