// radix_select.cu — K4, radix threshold selection (the k-th smallest key of
// each stream), hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/radix_select.py::radix_select_threshold (its pallas_call
// at :93, body _kernel :42).  That kernel holds the whole stream in one VMEM
// block and takes 32 one-bit, MSB-first masked-popcount rounds over the
// monotone float -> u32 map, carrying (prefix, remaining) from round to
// round.  A 4 MB stream (the PRODUCTION store, 1,048,576 keys) is past one
// CTA's shared memory, and CTAs run in no order, so here the rounds are 8-bit
// digits, one launch each, with the carry kept as histograms in global memory:
//
//   hist_kernel (x4)  grid (CTAs, B): each CTA first walks the finished
//                     rounds' histograms to the prefix so far (the digit is
//                     the first bin whose running count reaches the rank
//                     still to find, 255 if none: what the one-bit rounds
//                     pick), then histograms the digit of its keys that match
//                     the prefix in shared memory (warp-aggregated atomics)
//                     and adds its bins to the round's global histogram.
//   count_kernel      grid (CTAs, B): n_below = #{u < prefix}, one atomic
//                     per CTA.
//   finish_kernel     grid (B): tau = the prefix mapped back; k <= 0 gives
//                     (-inf, 0).
//
// The 4-round and 32-round forms find the same k-th smallest u32 (and the
// all-ones prefix when k exceeds the stream), so tau and n_below are the
// reference kernel's bits, -0.0 (below 0.0) included.  k is read from device
// memory: callers clamp it on the device.
//
// Bound on this card: bytes.  The function must read the keys once: 4.2 MB,
// 1.25 us at 3.35 TB/s, for 1,048,576 keys.  This design reads them five
// times (four rounds and the count; at 4 MB they stay in the 50 MB L2 after
// the first), and pays seven launches.  Fusing the rounds into one persistent
// launch with a grid-wide barrier, or caching the matching keys of round 0,
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;             // == the histogram's bin count
constexpr int kKeysPerCta = kThreads * 16;
constexpr int kMaxCtas = 1024;
constexpr int kWsInts = 4 * 256 + 1;      // per stream: 4 histograms, n_below
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ uint32_t sortable_u32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_sortable_u32(uint32_t u) {
  return __uint_as_float((u >> 31) == 0 ? ~u : (u & 0x7fffffffu));
}

// The prefix of the first `rounds` digits of the k-th smallest u32, from the
// finished rounds' histograms.  Every thread of the (256-thread) block calls.
__device__ uint32_t walk(const int* hist, int rounds, int k, int* scan) {
  const int tid = threadIdx.x;
  uint32_t prefix = 0;
  int rem = k;
  for (int r = 0; r < rounds; ++r) {
    scan[tid] = hist[r * 256 + tid];
    __syncthreads();
    for (int o = 1; o < 256; o <<= 1) {     // inclusive scan of the bins
      const int v = tid >= o ? scan[tid - o] : 0;
      __syncthreads();
      scan[tid] += v;
      __syncthreads();
    }
    const int d = min(__syncthreads_count(scan[tid] < rem), 255);
    rem -= d > 0 ? scan[d - 1] : 0;
    prefix |= (uint32_t)d << (24 - 8 * r);
    __syncthreads();
  }
  return prefix;
}

__global__ void __launch_bounds__(kThreads) hist_kernel(
    const float* keys, const int* k, int* ws, int L, int round) {
  __shared__ int scan[256];
  __shared__ int h[256];
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t row = blockIdx.y;
  int* hist = ws + row * kWsInts;
  const uint32_t prefix = walk(hist, round, k[row], scan);
  h[tid] = 0;
  __syncthreads();
  const uint32_t mask = round == 0 ? 0u : ~0u << (32 - 8 * round);
  const int shift = 24 - 8 * round;
  const float* kr = keys + row * L;
  const int stride = gridDim.x * kThreads;
  // i0 is uniform across the warp, so every lane reaches the match
  for (int i0 = blockIdx.x * kThreads + (tid & ~31); i0 < L; i0 += stride) {
    const int i = i0 + lane;
    int dig = 256;                          // no bin: past the end or no match
    if (i < L) {
      const uint32_t u = sortable_u32(kr[i]);
      if ((u & mask) == prefix) dig = (u >> shift) & 255;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, dig);
    if (dig < 256 && lane == __ffs(peers) - 1)
      atomicAdd(&h[dig], __popc(peers));
  }
  __syncthreads();
  if (h[tid]) atomicAdd(&hist[round * 256 + tid], h[tid]);
}

__global__ void __launch_bounds__(kThreads) count_kernel(
    const float* keys, const int* k, int* ws, int L) {
  __shared__ int scan[256];
  __shared__ int red[kThreads / 32];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.y;
  int* hist = ws + row * kWsInts;
  const uint32_t prefix = walk(hist, 4, k[row], scan);
  const float* kr = keys + row * L;
  int c = 0;
  for (int i = blockIdx.x * kThreads + tid; i < L; i += gridDim.x * kThreads)
    c += sortable_u32(kr[i]) < prefix;
  c = __reduce_add_sync(0xffffffffu, c);
  if ((tid & 31) == 0) red[tid >> 5] = c;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    if (t) atomicAdd(&hist[4 * 256], t);
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(
    const int* k, const int* ws, float* tau, int* n_below) {
  __shared__ int scan[256];
  const size_t row = blockIdx.x;
  const int* hist = ws + row * kWsInts;
  const int kk = k[row];
  const uint32_t prefix = walk(hist, 4, kk, scan);
  if (threadIdx.x == 0) {
    tau[row] = kk > 0 ? from_sortable_u32(prefix)
                      : -__int_as_float(0x7f800000);
    n_below[row] = kk > 0 ? hist[4 * 256] : 0;
  }
}

}  // namespace

extern "C" {

// int32 words of workspace radix_select_launch needs per stream.
long long radix_select_ws_ints() { return kWsInts; }

// (tau, n_below) of each row of keys [B, L] for k [B].  ws holds
// B * radix_select_ws_ints() int32 words (zeroed here).  Returns the CUDA
// error of the launches (0 = success).
int radix_select_launch(const float* keys, const int* k, float* tau,
                        int* n_below, int* ws, long long rows, long long L,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ws, 0, (size_t)rows * kWsInts * 4, st);
  if (err != cudaSuccess) return (int)err;
  long long ctas = (L + kKeysPerCta - 1) / kKeysPerCta;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int nr = (int)(rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY);
    const float* kr = keys + (size_t)r0 * L;
    const int* kk = k + r0;
    int* w = ws + (size_t)r0 * kWsInts;
    const dim3 grid((unsigned)ctas, nr);
    for (int round = 0; round < 4; ++round) {
      hist_kernel<<<grid, kThreads, 0, st>>>(kr, kk, w, (int)L, round);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    count_kernel<<<grid, kThreads, 0, st>>>(kr, kk, w, (int)L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    finish_kernel<<<nr, kThreads, 0, st>>>(kk, w, tau + r0, n_below + r0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* radix_select_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
