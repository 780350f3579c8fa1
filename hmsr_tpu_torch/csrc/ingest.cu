// K8 and K9: the raw burst's ingestion on the card.
//
// K8 replaces the JAX package's host normalizer,
// hmsr_tpu/io/native_loader.py:59 normalize_burst, whose C++ is
// native/burst_loader.cpp:19-38 normalize_rows and :67-77
// hmsr_normalize_burst (host code, no pl.pallas_call):
//   out[f, y, x] = (float(in[f, y, x]) - black) * gain
// with (black, gain) those of the CFA phase (y & 1, x & 1). The wrapper
// resolves each phase's pair on the host (gain = (wb[c] / wb[1]) /
// (white - black[c]) in numpy float32, c = cfa[phase]) and passes the four
// pairs by value, so any CFA layout and channel count take the same code.
// The subtract and the multiply round once each (__fsub_rn, __fmul_rn: never
// contracted into an FMA), as numpy's float32 ops and the C++ loop do, so
// K8 equals both bit for bit.
//
// K9 replaces native_loader.py:98 unpack_raw10 and :115 unpack_raw12 (C++
// hmsr_unpack_raw10/12): MIPI RAW10 (5 bytes -> 4 pixels) and RAW12 (3
// bytes -> 2 pixels), one routine with the bit depth as a template
// parameter: the high 8 bits of pixel k are byte k, its low bits sit at
// bit (bits - 8) * k of the group's last byte. Integer work: bit for bit
// by construction.
//
// Bound on the H100: bytes, both. K8 reads 2 and writes 4 bytes per pixel:
// 1.44 GB for 20 x 3000 x 4000, 0.43 ms at 3.35 TB/s. K9 at 12 MP: RAW10
// reads 15 MB and writes 24 MB (0.0116 ms), RAW12 18 MB and 24 MB.
//
// Design. K8: a grid-stride loop over rows, one row per block of 256
// threads at a time, the grid as many blocks as the card holds at once.
// Each thread picks its row's two (black, gain) pairs once, then converts
// 4 pixels per step: one 8-byte uint16 load, one 16-byte float store, so a
// warp's store fills 512 contiguous bytes (with 8 pixels a step, each of
// the two 16-byte stores filled half of every sector it touched), streaming
// (evict first: every byte is touched once). A thread's four steps (a
// 4000-pixel row is 1000 steps: one pass) load together before any is
// stored, so each resident block keeps its whole row's loads in flight.
// The vector steps start at the row's first 8-byte-aligned input pixel;
// the pixels before it and the row's tail past the last whole step take a
// scalar path. Where that pixel's output is not 16-byte aligned too (an
// input base 2, 4 or 6 bytes off an 8-byte boundary) the whole row is
// scalar. An odd width only moves each row's head. K9: one thread per
// group, byte loads (a warp's 32 groups are 160 or 96 contiguous bytes)
// and one 8- or 4-byte store of the group's pixels.
//
// Why CUDA C++ and not Triton: both are elementwise passes that Triton
// would serve, but the port has no Triton anywhere, and its one build
// (ops/_build.py: nvcc, ctypes, the launch-error check) already serves the
// other kernels; a second toolchain for two short kernels is not worth it.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int NB_THREADS = 256;     // K8 block: one row at a time
constexpr int NB_STEPS = 4;         // K8 4-pixel steps per thread, loaded together
constexpr int UP_THREADS = 256;     // K9 block: one group per thread

// Blocks of `kernel` that the current device holds at once, at least 1;
// `cache` (one per kernel, by device) keeps the answer.
static int resident_blocks(const void* kernel, int threads, int (&cache)[16]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = cache[dev & 15];
  if (c == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    c = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return c;
}

__device__ __forceinline__ float norm_px(uint32_t v, float b, float g) {
  return __fmul_rn(__fsub_rn((float)v, b), g);
}

// Four pixels from one 8-byte load (little endian: pixel 2i in the low
// half of word i); pixels 0 and 2 take (b0, g0), 1 and 3 (b1, g1).
__device__ __forceinline__ float4 norm4(uint2 v, float b0, float g0, float b1,
                                        float g1) {
  return make_float4(norm_px(v.x & 0xffffu, b0, g0), norm_px(v.x >> 16, b1, g1),
                     norm_px(v.y & 0xffffu, b0, g0), norm_px(v.y >> 16, b1, g1));
}

// v[4 * (y & 1) + 2 * (x & 1)] = black, v[... + 1] = gain of the CFA phase.
struct Phases {
  float v[8];
};

__global__ void __launch_bounds__(NB_THREADS)
normalize_kernel(const uint16_t* __restrict__ in, float* __restrict__ out,
                 long long rows, int h, int w, Phases ph) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    // the row's pairs at even and odd x (constant indices: no local memory)
    const bool odd_row = (r % h) & 1;
    const float b_even = odd_row ? ph.v[4] : ph.v[0];
    const float g_even = odd_row ? ph.v[5] : ph.v[1];
    const float b_odd = odd_row ? ph.v[6] : ph.v[2];
    const float g_odd = odd_row ? ph.v[7] : ph.v[3];
    const uint16_t* src = in + r * w;
    float* dst = out + r * w;
    int head = (int)(((8u - ((uint32_t)(uintptr_t)src & 7u)) & 7u) >> 1);
    head = head < w ? head : w;
    const bool vec = (((uintptr_t)(dst + head)) & 15u) == 0;
    const int v0 = vec ? head : 0;
    const int nvec = vec ? (w - head) >> 2 : 0;
    const int v1 = v0 + 4 * nvec;
    // vector steps: x = v0 + 4k, so pixel j of a step has x parity (v0 + j) & 1
    const bool swap = v0 & 1;
    const float be = swap ? b_odd : b_even, ge = swap ? g_odd : g_even;
    const float bo = swap ? b_even : b_odd, go = swap ? g_even : g_odd;
    const uint2* s2 = reinterpret_cast<const uint2*>(src + v0);
    float4* d4 = reinterpret_cast<float4*>(dst + v0);
    for (int k0 = threadIdx.x; k0 < nvec; k0 += NB_STEPS * NB_THREADS) {
      uint2 v[NB_STEPS];
#pragma unroll
      for (int u = 0; u < NB_STEPS; ++u)
        if (k0 + u * NB_THREADS < nvec) v[u] = __ldcs(s2 + k0 + u * NB_THREADS);
#pragma unroll
      for (int u = 0; u < NB_STEPS; ++u)
        if (k0 + u * NB_THREADS < nvec)
          __stcs(d4 + k0 + u * NB_THREADS, norm4(v[u], be, ge, bo, go));
    }
    // scalar pixels: [0, v0) and [v1, w)
    const int n_scalar = v0 + (w - v1);
    for (int s = threadIdx.x; s < n_scalar; s += NB_THREADS) {
      const int x = s < v0 ? s : v1 + (s - v0);
      __stcs(dst + x, (x & 1) ? norm_px(src[x], b_odd, g_odd)
                              : norm_px(src[x], b_even, g_even));
    }
  }
}

// K8: (n, h, w) uint16 -> float32, contiguous; (b_yx, g_yx) per CFA phase.
extern "C" int hmsr_normalize_bayer(const uint16_t* in, float* out, int n, int h,
                                    int w, float b00, float g00, float b01, float g01,
                                    float b10, float g10, float b11, float g11,
                                    void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return (int)cudaGetLastError();
  const Phases ph = {{b00, g00, b01, g01, b10, g10, b11, g11}};
  const long long rows = (long long)n * h;
  static int cache[16];
  const int cap = resident_blocks((const void*)normalize_kernel, NB_THREADS, cache);
  const int grid = rows < cap ? (int)rows : cap;
  normalize_kernel<<<grid, NB_THREADS, 0, (cudaStream_t)stream>>>(in, out, rows, h,
                                                                   w, ph);
  return (int)cudaGetLastError();
}

// The pixels of one packed group, stored at once.
template <int PX>
struct alignas(2 * PX) GroupPx {
  uint16_t v[PX];
};

template <int BITS>
__global__ void __launch_bounds__(UP_THREADS)
unpack_kernel(const uint8_t* __restrict__ in, uint16_t* __restrict__ out,
              long long groups) {
  constexpr int LOW = BITS - 8;         // low bits per pixel
  constexpr int PX = 8 / LOW;           // pixels per group
  constexpr int BYTES = PX + 1;
  for (long long g = (long long)blockIdx.x * UP_THREADS + threadIdx.x; g < groups;
       g += (long long)gridDim.x * UP_THREADS) {
    const uint8_t* p = in + g * BYTES;
    const uint32_t low = __ldg(p + PX);
    GroupPx<PX> q;
#pragma unroll
    for (int k = 0; k < PX; ++k)
      q.v[k] = (uint16_t)(((uint32_t)__ldg(p + k) << LOW) |
                          ((low >> (LOW * k)) & ((1u << LOW) - 1u)));
    reinterpret_cast<GroupPx<PX>*>(out)[g] = q;
  }
}

template <int BITS>
static void launch_unpack(const uint8_t* in, uint16_t* out, long long groups,
                          cudaStream_t st) {
  const long long need = (groups + UP_THREADS - 1) / UP_THREADS;
  static int cache[16];
  const int cap = resident_blocks((const void*)unpack_kernel<BITS>, UP_THREADS, cache);
  unpack_kernel<BITS><<<need < cap ? (int)need : cap, UP_THREADS, 0, st>>>(in, out,
                                                                        groups);
}

// K9: `groups` packed groups of `bits` (10 or 12) -> their pixels, uint16.
extern "C" int hmsr_unpack_raw(const uint8_t* in, uint16_t* out, int groups, int bits,
                               void* stream) {
  if (groups <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  if (bits == 10)
    launch_unpack<10>(in, out, groups, st);
  else if (bits == 12)
    launch_unpack<12>(in, out, groups, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
