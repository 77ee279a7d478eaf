// radix_select.cu — K4, radix threshold selection (the k-th smallest key of
// each stream), hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/radix_select.py::radix_select_threshold (its pallas_call
// at :93, body _kernel :42).  That kernel holds the whole stream in one VMEM
// block and takes 32 one-bit, MSB-first masked-popcount rounds over the
// monotone float -> u32 map, carrying (prefix, remaining) from round to
// round.  Here the rounds take 8-bit digits, MSB first (four rounds; 11-bit
// digits, three rounds, measured slower at every shape, PERF.md), and one
// call is one launch of one of two kernels, which the launch plan
// (radix_select.py::launch_plan) picks by the stream's length and the number
// of streams:
//
//   row_kernel   a row that fits one CTA's shared memory: one CTA a row
//                stages the row once (cp.async) and runs every round there.
//   grid_kernel  a longer row: a cooperative launch of as many CTAs as the
//                card holds at once, split among the rows.  Each CTA stages
//                its contiguous chunk of the row once (or, past the card's
//                shared memory in total, reads it again each round); each
//                round it adds its chunk's histogram to the row's global
//                one, and a barrier across the row's CTAs (a release
//                increment, acquiring loads) separates the rounds.  The last
//                CTA of a row to finish zeroes the row's workspace, so no
//                launch needs a memset.
//
// A round histograms the digit of the keys that match the prefix so far
// (shared-memory atomics, which the compiler aggregates across a warp); the
// digit is the first bin whose running count reaches the rank still to
// find, the top bin if none (what the one-bit rounds pick), found by warp 0
// alone in one shuffle scan of this round's histogram, while the other warps
// zero the next round's.  The forms find the same k-th smallest u32 (and
// the all-ones prefix when k exceeds the stream), so tau is the reference
// kernel's bits, -0.0 (below 0.0) included.  n_below = k - the rank left
// after the last round: the sum, over the rounds, of the keys in the bins
// below the chosen digit, since a key below the prefix first differs from it
// at a digit where it is smaller.  k is read from device memory.
//
// Bound on this card: bytes.  The function must read the keys once: 4.2 MB,
// 1.25 us at 3.35 TB/s, for 1,048,576 keys; this design reads them once
// (when staged).  What bounds it instead is latency: a round of the grid
// kernel is a histogram pass, a grid barrier and a global read, about 3.5 us
// (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGridThreads = 1024;   // grid_kernel's CTA (one an SM)

constexpr int kBits = 8;              // a digit's width
constexpr int kRounds = 32 / kBits;
constexpr int kBins = 1 << kBits;
// shared words of a padded histogram (pad)
constexpr int kHistWords = kBins + kBins / 32;
// workspace ints a row of grid_kernel takes: the rounds' histograms and the
// row's barrier counter (padded)
constexpr int kWsInts = kRounds * kBins + 4;

// round r: the digit's shift, the mask of the bits above it
__device__ __forceinline__ int shift(int r) { return 32 - kBits * (r + 1); }
__device__ __forceinline__ uint32_t above(int r) {
  return r == 0 ? 0u : ~0u << (32 - kBits * r);
}

__device__ __forceinline__ uint32_t sortable_u32(uint32_t u) {
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_sortable_u32(uint32_t u) {
  return __uint_as_float((u >> 31) == 0 ? ~u : (u & 0x7fffffffu));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy n words from src to dst (shared) by cp.async, 16 bytes a copy if
// vec (both ends 16-byte aligned, n a multiple of 4), else 4; every thread
// of the block calls, and returns when the whole copy has landed.
__device__ void stage(uint32_t* dst, const float* src, int n, bool vec) {
  if (vec) {
    for (int c = 4 * threadIdx.x; c < n; c += 4 * blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + c)),
                   "l"(src + c));
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(dst + c)),
                   "l"(src + c));
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
}

// A histogram's bin b lives at word pad(b): one spare word every 32 bins,
// so that warp 0's lanes, each reading its own run of bins, hit distinct
// banks.
__device__ __forceinline__ int pad(int b) { return b + (b >> 5); }

// Add the digit (u >> shift) % kBins of every key u of [0, n) whose bits
// above the digit equal prefix to h (padded bins).  A warp takes 32 x
// kUnroll keys at a time, kUnroll loads in flight a thread; the compiler
// aggregates a warp's atomics on one bin.  get(i) gives key i's u32.
constexpr int kUnroll = 4;

template <class Get>
__device__ __forceinline__ void histogram(const Get& get, int n,
                                          uint32_t prefix, int r, int* h) {
  const uint32_t ab = above(r);
  const int sh = shift(r);
  const int lane = threadIdx.x & 31;
  constexpr int kBlock = 32 * kUnroll;
  const int whole = n - n % kBlock;
  for (int i0 = (threadIdx.x & ~31) * kUnroll; i0 < whole;
       i0 += blockDim.x * kUnroll) {
    uint32_t u[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) u[j] = get(i0 + 32 * j + lane);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if ((u[j] & ab) == prefix)
        atomicAdd(&h[pad((int)((u[j] >> sh) & (kBins - 1)))], 1);
  }
  for (int i = whole + threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t u = get(i);
    if ((u & ab) == prefix)
      atomicAdd(&h[pad((int)((u >> sh) & (kBins - 1)))], 1);
  }
}

// The digit of this round from its histogram h[0, kBins) (padded bins, in
// shared memory) and the rank still to find: res[0] = the first bin whose
// running count reaches rem (kBins - 1 if none; 0 if rem <= 0), res[1] =
// the keys in the bins below it.  Warp 0 alone calls: a lane sums its run
// of kBins / 32 bins, one warp-shuffle scan, and the lane whose run holds
// the crossing walks it.
__device__ void pick_digit(const int* h, int rem, int* res) {
  const int lane = threadIdx.x & 31;
  constexpr int per = kBins / 32;
  const int b0 = lane * per;
  int own = 0;
  for (int q = 0; q < per; ++q) own += h[pad(b0 + q)];
  int s = own;                                 // inclusive scan
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += v;
  }
  const int total = __shfl_sync(0xffffffffu, s, 31);
  const int excl = s - own;
  if (lane == 0 && rem <= 0) {
    res[0] = 0;
    res[1] = 0;
  } else if (lane == 0 && rem > total) {
    res[0] = kBins - 1;
    res[1] = total - h[pad(kBins - 1)];
  }
  if (rem > 0 && excl < rem && s >= rem) {     // one lane
    int c = excl;
    for (int b = b0; b < b0 + per; ++b) {
      if (c + h[pad(b)] >= rem) {
        res[0] = b;
        res[1] = c;
        break;
      }
      c += h[pad(b)];
    }
  }
}

__device__ __forceinline__ void write_result(float* tau, int* n_below,
                                             long long row, int k,
                                             uint32_t prefix, int rem) {
  tau[row] = k > 0 ? from_sortable_u32(prefix) : -__int_as_float(0x7f800000);
  n_below[row] = k > 0 ? k - rem : 0;
}

// One CTA a row of L keys (at least 64 threads); dynamic shared memory:
// two histograms of kHistWords (one filled while the other is zeroed),
// then the row's float bits (L words), mapped to u32 as they are read.
__global__ void __launch_bounds__(1024) row_kernel(
    const float* __restrict__ keys, const int* __restrict__ k,
    float* __restrict__ tau, int* __restrict__ n_below, int L, bool vec) {
  extern __shared__ __align__(16) int smem[];
  uint32_t* su = reinterpret_cast<uint32_t*>(smem + 2 * kHistWords);
  __shared__ int res[2];
  const long long row = blockIdx.x;
  for (int b = threadIdx.x; b < kHistWords; b += blockDim.x) smem[b] = 0;
  stage(su, keys + row * L, L, vec);
  const int kk = k[row];
  uint32_t prefix = 0;
  int rem = kk;
  for (int r = 0; r < kRounds; ++r) {
    int* h = smem + (r & 1) * kHistWords;
    int* next = smem + (~r & 1) * kHistWords;
    histogram([&](int i) { return sortable_u32(su[i]); }, L, prefix, r, h);
    __syncthreads();
    if (threadIdx.x < 32) {
      pick_digit(h, rem, res);
    } else {
      for (int b = threadIdx.x - 32; b < kHistWords; b += blockDim.x - 32)
        next[b] = 0;
    }
    __syncthreads();
    prefix |= (uint32_t)res[0] << shift(r);
    rem -= res[1];
  }
  if (threadIdx.x == 0) write_result(tau, n_below, row, kk, prefix, rem);
}

// Wait until the row's barrier counter reaches target (the row's CTAs
// count themselves in, a release each, and wait with acquiring loads, as
// CUTLASS's grid barrier does; the counter only grows within a launch).
__device__ __forceinline__ void row_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
    } while (v < target);
  }
  __syncthreads();
}

// A cooperative grid of groups x per_row CTAs; group g takes rows g,
// g + groups, ...; CTA c of a group owns keys [c * chunk, (c+1) * chunk) of
// the row, staged in shared memory if `staged`.  Dynamic shared memory: the
// CTA's histogram and a copy of the row's (kHistWords each), then the chunk
// if staged.  ws holds rows x kWsInts ints, zero on entry and left zero.
__global__ void __launch_bounds__(kGridThreads, 1) grid_kernel(
    const float* __restrict__ keys, const int* __restrict__ k,
    float* __restrict__ tau, int* __restrict__ n_below, int* ws,
    long long rows, int L, int per_row, int groups, int chunk, bool staged,
    bool vec) {
  extern __shared__ __align__(16) int smem[];
  int* h = smem;
  int* g = smem + kHistWords;
  uint32_t* su = reinterpret_cast<uint32_t*>(smem + 2 * kHistWords);
  __shared__ int res[2];
  __shared__ int last;
  const int c = blockIdx.x % per_row;
  const int c0 = (int)min((long long)c * chunk, (long long)L);
  const int n = min(c0 + chunk, L) - c0;
  for (int b = threadIdx.x; b < kHistWords; b += blockDim.x) h[b] = 0;
  for (long long row = blockIdx.x / per_row; row < rows; row += groups) {
    const float* kr = keys + row * L + c0;
    int* hist = ws + row * kWsInts;
    unsigned* bar = reinterpret_cast<unsigned*>(hist + kRounds * kBins);
    if (staged) stage(su, kr, n, vec);
    __syncthreads();
    const int kk = k[row];
    uint32_t prefix = 0;
    int rem = kk;
    for (int r = 0; r < kRounds; ++r) {
      if (staged)
        histogram([&](int i) { return sortable_u32(su[i]); }, n, prefix, r,
                  h);
      else
        histogram([&](int i) { return sortable_u32(__float_as_uint(kr[i])); },
                  n, prefix, r, h);
      __syncthreads();
      // the CTA's counts into the row's histogram; h is left zero
      int* hr = hist + r * kBins;
      for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
        const int v = h[pad(b)];
        if (v) {
          atomicAdd(&hr[b], v);
          h[pad(b)] = 0;
        }
      }
      row_barrier(bar, (unsigned)((r + 1) * per_row));
      for (int b = threadIdx.x; b < kBins; b += blockDim.x)
        g[pad(b)] = __ldcg(&hr[b]);
      __syncthreads();
      if (threadIdx.x < 32) pick_digit(g, rem, res);
      __syncthreads();
      prefix |= (uint32_t)res[0] << shift(r);
      rem -= res[1];
    }
    if (c == 0 && threadIdx.x == 0)
      write_result(tau, n_below, row, kk, prefix, rem);
    // the row's last CTA to finish reading its histograms zeroes them
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(bar, 1u) == (unsigned)((kRounds + 1) * per_row - 1);
    __syncthreads();
    if (last) {
      for (int i = threadIdx.x; i < kWsInts; i += blockDim.x) hist[i] = 0;
    }
    __syncthreads();
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// int32 words of workspace a row of the grid kernel needs.
long long radix_select_ws_ints() { return kWsInts; }

// The current device's limits for the launch plan: out[0] SMs, out[1] the
// dynamic shared memory a block may opt into (less `reserve` bytes, kept
// for the kernels' static shared memory), out[2] the CTAs of the grid
// kernel an SM holds at that shared memory.  Sets both kernels' dynamic
// shared memory limit to out[1], the most a launch plan asks for.  Returns
// the CUDA error (0 = success).
int radix_select_device_limits(long long reserve, long long* out) {
  int dev, sms, optin, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int smem = optin - (int)reserve;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, grid_kernel, kGridThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = sms;
  out[1] = smem;
  out[2] = blocks;
  return 0;
}

// (tau, n_below) of each row of keys [B, L] for k [B], by the launch plan
// d: rows, L, kernel (0 row, 1 grid), threads, grid, CTAs a row, row
// groups, chunk, staged, dynamic shared bytes.  ws is the grid kernel's
// zeroed workspace (rows x radix_select_ws_ints() ints; left zero) or null
// for the row kernel.  radix_select_device_limits must have run on this
// device first (it lifts the kernels' shared memory limit).  Returns the
// CUDA error of the launch (0 = success); a plan the kernel cannot run is
// refused as cudaErrorInvalidValue.
int radix_select_launch(const float* keys, const int* k, float* tau,
                        int* n_below, int* ws, const long long* d,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = d[0], L = d[1], grid_kind = d[2], threads = d[3];
  const long long grid = d[4], per_row = d[5], groups = d[6], chunk = d[7];
  const bool staged = d[8] != 0;
  const long long smem = d[9];
  if (rows < 1 || L < 1 || L >= (1LL << 30) || smem < 2LL * kHistWords * 4)
    return (int)cudaErrorInvalidValue;
  if (!grid_kind) {
    if (grid != rows || grid > 0x7fffffffLL || threads < 64 ||
        threads > 1024 || threads % 32 || smem < (2 * kHistWords + L) * 4)
      return (int)cudaErrorInvalidValue;
    const bool vec = aligned16(keys) && L % 4 == 0;
    row_kernel<<<(unsigned)grid, (unsigned)threads, smem, st>>>(
        keys, k, tau, n_below, (int)L, vec);
    return (int)cudaGetLastError();
  }
  if (threads != kGridThreads || groups < 1 || per_row < 1 ||
      grid != groups * per_row || groups > rows || chunk < 1 ||
      chunk * per_row < L ||
      (staged && smem < (2 * kHistWords + chunk) * 4) || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  bool vec = aligned16(keys) && L % 4 == 0 && chunk % 4 == 0;
  int L32 = (int)L, pr = (int)per_row, gr = (int)groups, ch = (int)chunk;
  bool stg = staged;
  long long nrows = rows;
  void* args[] = {(void*)&keys, (void*)&k,  (void*)&tau, (void*)&n_below,
                  (void*)&ws,   (void*)&nrows, (void*)&L32, (void*)&pr,
                  (void*)&gr,   (void*)&ch, (void*)&stg, (void*)&vec};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)grid_kernel, dim3((unsigned)grid), dim3(kGridThreads),
      args, (size_t)smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* radix_select_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
