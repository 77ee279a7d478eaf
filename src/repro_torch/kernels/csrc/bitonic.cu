// bitonic.cu — K2, the stable row co-sort of (keys, vals, flags), hand-written
// for Hopper (sm_90a) as an LSD radix sort.
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/bitonic.py::bitonic_sort_kvf (its pallas_call at :89, the
// network _sort_network :59).  The name stays; the algorithm is a radix sort.
// Each key maps to a u32 whose unsigned order is the float order with -0.0
// before 0.0 (sortable_u32); four 8-bit digit passes, least significant
// first, each stable, order the (u32 key, row index) pairs.  A stable LSD
// sort yields the one stable order, so the result is exactly the stable
// argsort on the u32 map that the port's plain version computes, bit for
// bit, at any row length.  Keys come back through the inverse map; vals and
// flags are gathered once, by index, at the end.
//
// Every pass ranks digits the same way: warp w owns a contiguous chunk of
// the tile and walks it 32 items at a time; eight ballots, one per digit
// bit, group the lanes with equal digits (cheaper than __match_any_sync,
// whose throughput bounded a pass on one SM), so an item's rank is its
// warp's running count of that digit plus its lane rank among the peers,
// and the lowest peer adds the group's size to the count.  Counts are laid
// out digit-major, warp-minor and scanned once, which keeps equal digits in
// input order.
//
// Two regimes, chosen by row length in bitonic_launch:
//
//   1. row_sort_kernel   rows of up to kRowTile = 4096 keys, grid (rows):
//                        one CTA per row, up to 8 keys per thread held in
//                        registers; each pass scatters the pairs into
//                        shared memory, and the last writes the outputs
//                        coalesced.  One launch.  128 threads a row when
//                        there are enough rows to fill the card, 256 or 512
//                        otherwise.
//   2. longer rows: a multi-CTA onesweep sort, five launches.
//      hist_kernel       grid (n / 2048, rows): the four 256-bin digit
//                        histograms of each 2048-key slice of a row, from
//                        one read of the keys, and the zeroing of the row's
//                        look-back words and tile counters.
//      sweep_kernel x 4  grid (n / 2048, rows), one launch per digit: a CTA
//                        takes a tile id from an atomic counter (so a tile
//                        waits only on tiles that already run), ranks its
//                        2048 pairs in shared memory, publishes its digit
//                        counts and finds its global offset per digit by
//                        decoupled look-back over the earlier tiles' counts
//                        (status and count packed in one 32-bit word, eight
//                        words loaded at once), then writes its pairs in
//                        digit runs.  Each CTA sums the slice histograms of
//                        its digit and scans them for the digit's start.
//                        The last pass gathers vals and flags.
//
// Bound on this card: bytes.  The function reads keys, vals and flags once
// and writes them once, 24 bytes per element: 25.2 MB, about 7.5 us at
// 3.35 TB/s, for [1024, 1024] rows; 1.6 MB (0.47 us) for [1, 65536].  A
// row of up to 4096 keys is read from and written to global memory once,
// every pass in shared memory; such rows are bound by the ranking's
// instructions and syncs, one CTA's latency when rows are few.  A longer
// row reads its keys twice (the histogram and the first pass) and moves 16
// bytes per element through global memory for each of three intermediate
// passes; at 65536 keys that is ~3 MB, which stays in L2, so five
// launches' latency bounds it.  Skipping a pass whose digit is the same
// for the whole row is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kPasses = 4;
constexpr int kItems = 8;              // keys per thread
constexpr int kRowTile = 4096;         // longest row of one CTA (512 threads)
constexpr int kManyRows = 512;         // rows that fill the card at 128 threads
constexpr int kSweepThreads = 256;
constexpr int kSweepTile = kSweepThreads * kItems;   // 2048 keys per CTA
constexpr int kHistThreads = 256;
constexpr int kHistTile = kHistThreads * kItems;     // 2048 keys per CTA
constexpr int kLookBatch = 8;          // look-back words loaded at once
constexpr long long kMaxGridY = 65535;
constexpr uint32_t kFlagAggregate = 1u << 30;   // the tile's own count
constexpr uint32_t kFlagPrefix = 2u << 30;      // count of tiles 0..t
constexpr uint32_t kCountMask = (1u << 30) - 1;

__device__ __forceinline__ uint32_t sortable_u32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_sortable_u32(uint32_t u) {
  return __uint_as_float((u >> 31) ? (u & 0x7fffffffu) : ~u);
}

// A look-back word carries its own payload, so relaxed GPU-scope accesses
// suffice, and the loads of one batch can be in flight together.
__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1;
}

// The lanes of the warp whose item is valid and has digit d (0..255), from
// one ballot per digit bit: cheaper than __match_any_sync, whose throughput
// bounds a pass that one SM carries alone.
__device__ __forceinline__ unsigned digit_peers(int d, bool valid) {
  unsigned peers = __ballot_sync(0xffffffffu, valid);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned m = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? m : ~m;
  }
  return peers;
}

// Exclusive prefix sum across the block (every thread calls; red holds 32).
__device__ int block_excl_scan(int x, int* red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) red[w] = inc;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < w && i < nw; ++i) before += red[i];
  return before + inc - x;
}

// Per-warp digit counts of the items in registers: item j of a lane is
// valid when j < steps and ok[j]; cnt is [warps][kBins].  peers[j] gets
// the item's peer mask, which scatter_digits reuses.
__device__ __forceinline__ void count_digits(const uint32_t* k, const bool* ok,
                                             int steps, int shift, int* cnt,
                                             unsigned* peers) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < steps) {
      const int d = (k[j] >> shift) & 0xff;
      peers[j] = digit_peers(d, ok[j]);
      if (ok[j] && lane == __ffs(peers[j]) - 1)
        cnt[w * kBins + d] += __popc(peers[j]);
      __syncwarp();
    }
  }
}

// Turns cnt into each (warp, digit)'s first slot, digit-major and
// warp-minor: thread t owns kDPT consecutive digits from t * kDPT
// (blockDim.x * kDPT >= kBins).  Returns the block's count of the thread's
// first digit (the tile's count of digit t when kDPT is 1), and the first
// slot of that digit in *first.
template <int kDPT>
__device__ __forceinline__ int warp_starts(int* cnt, int warps, int* red,
                                           int* first) {
  const int d0 = threadIdx.x * kDPT;
  const bool owns = d0 < kBins;
  int tot[kDPT];
  int sum = 0;
#pragma unroll
  for (int q = 0; q < kDPT; ++q) {
    tot[q] = 0;
    if (owns)
      for (int w = 0; w < warps; ++w) tot[q] += cnt[w * kBins + d0 + q];
    sum += tot[q];
  }
  int start = block_excl_scan(sum, red);
  *first = start;
  if (owns) {
#pragma unroll
    for (int q = 0; q < kDPT; ++q) {
      int run = start;
      for (int w = 0; w < warps; ++w) {
        const int c = cnt[w * kBins + d0 + q];
        cnt[w * kBins + d0 + q] = run;
        run += c;
      }
      start += tot[q];
    }
  }
  return tot[0];
}

// Scatters the items to skey/sidx at their stable slots (cnt from
// warp_starts, advanced here; peers from count_digits).
__device__ __forceinline__ void scatter_digits(const uint32_t* k, const int* ix,
                                               const bool* ok,
                                               const unsigned* peer_masks,
                                               int steps, int shift, int* cnt,
                                               uint32_t* skey, int* sidx) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (j < steps) {
      const int d = (k[j] >> shift) & 0xff;
      const unsigned peers = peer_masks[j];
      int pos = 0;
      if (ok[j]) pos = cnt[w * kBins + d] + __popc(peers & lanes_below());
      __syncwarp();
      if (ok[j]) {
        if (lane == __ffs(peers) - 1) cnt[w * kBins + d] += __popc(peers);
        skey[pos] = k[j];
        sidx[pos] = ix[j];
      }
      __syncwarp();
    }
  }
}

// ---- regime 1: one CTA per row ---------------------------------------------

template <int kThreads>
__global__ void __launch_bounds__(kThreads) row_sort_kernel(
    const float* keys, const int* vals, const int* flags, float* ok_out,
    int* ov, int* of, int n) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kDPT = kThreads >= kBins ? 1 : kBins / kThreads;
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;
  int* sidx = reinterpret_cast<int*>(smem + n);
  int* cnt = sidx + n;                       // [kWarps][kBins]
  __shared__ int red[32];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const size_t row = (size_t)blockIdx.x * n;
  // warp w owns [w * C, (w + 1) * C), C a multiple of 32
  const int C = ((n + kWarps - 1) / kWarps + 31) & ~31;
  const int steps = C >> 5;
  uint32_t k[kItems];
  int ix[kItems];
  bool ok[kItems];
  unsigned peers[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = w * C + j * 32 + lane;
    ok[j] = j < steps && i < n;
    k[j] = ok[j] ? sortable_u32(keys[row + i]) : 0u;
    ix[j] = i;
  }
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    for (int b = tid; b < kWarps * kBins; b += kThreads) cnt[b] = 0;
    __syncthreads();
    count_digits(k, ok, steps, shift, cnt, peers);
    __syncthreads();
    int first;
    warp_starts<kDPT>(cnt, kWarps, red, &first);
    __syncthreads();
    scatter_digits(k, ix, ok, peers, steps, shift, cnt, skey, sidx);
    __syncthreads();
    if (pass + 1 < kPasses) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = w * C + j * 32 + lane;
        if (ok[j]) { k[j] = skey[i]; ix[j] = sidx[i]; }
      }
    }
  }
  for (int p = tid; p < n; p += kThreads) {
    const size_t q = row + sidx[p];
    ok_out[row + p] = from_sortable_u32(skey[p]);
    ov[row + p] = vals[q];
    of[row + p] = flags[q];
  }
}

// ---- regime 2: onesweep over many CTAs -------------------------------------

// part[row][slice][pass][digit]: the digit counts of one kHistTile slice of
// the row.  Also zeroes the row's look-back words and tile counters
// (zero_words of them from zero), which the sweeps use next.
__global__ void __launch_bounds__(kHistThreads) hist_kernel(
    const float* keys, uint32_t* part, uint32_t* zero, int zero_words,
    int n) {
  __shared__ uint32_t h[kPasses * kBins];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int b = tid; b < kPasses * kBins; b += kHistThreads) h[b] = 0;
  __syncthreads();
  const size_t row = (size_t)blockIdx.y * n;
  const int base = blockIdx.x * kHistTile;
  uint32_t u[kItems];
  bool in[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {   // every load in flight at once
    const int i = base + j * kHistThreads + tid;
    in[j] = i < n;
    u[j] = in[j] ? sortable_u32(keys[row + i]) : 0u;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int d = (u[j] >> (8 * pass)) & 0xff;
      const unsigned peers = digit_peers(d, in[j]);
      if (in[j] && lane == __ffs(peers) - 1)
        atomicAdd(&h[pass * kBins + d], (uint32_t)__popc(peers));
    }
  }
  __syncthreads();
  uint32_t* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x)
                             * kPasses * kBins;
  for (int b = tid; b < kPasses * kBins; b += kHistThreads) out[b] = h[b];
  uint32_t* z = zero + (size_t)blockIdx.y * zero_words;
  for (int i = blockIdx.x * kHistThreads + tid; i < zero_words;
       i += gridDim.x * kHistThreads)
    z[i] = 0;
}

// One digit pass over a long row.  Pass 0 reads the keys (index = slot);
// the last pass writes ok/ov/of, the others the (u32 key, index) pairs.
// part is the row's slice histograms (this pass's digits at +pass*kBins);
// look[row][tile][digit] and ctr[row][0] are this pass's, zeroed by
// hist_kernel.
__global__ void __launch_bounds__(kSweepThreads) sweep_kernel(
    const float* keys, const int* vals, const int* flags,
    const uint32_t* src_k, const int* src_i, uint32_t* dst_k, int* dst_i,
    float* ok_out, int* ov, int* of, const uint32_t* part, int slices,
    uint32_t* look, int* ctr, int n, int pass, int look_stride,
    int ctr_stride) {
  constexpr int kWarps = kSweepThreads / 32;
  constexpr int kC = kItems * 32;            // items per warp
  __shared__ uint32_t skey[kSweepTile];
  __shared__ int sidx[kSweepTile];
  __shared__ int cnt[kWarps * kBins];
  __shared__ int delta[kBins];
  __shared__ int red[32];
  __shared__ int s_tile;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int r = blockIdx.y;
  const size_t row = (size_t)r * n;
  const int shift = 8 * pass;
  const bool first = src_k == nullptr, last = dst_k == nullptr;
  if (tid == 0) s_tile = atomicAdd(&ctr[(size_t)r * ctr_stride], 1);
  for (int b = tid; b < kWarps * kBins; b += kSweepThreads) cnt[b] = 0;
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kSweepTile;
  const int len = min(kSweepTile, n - base);
  uint32_t k[kItems];
  int ix[kItems];
  bool ok[kItems];
  unsigned peers[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = w * kC + j * 32 + lane;
    ok[j] = i < len;
    const size_t g = row + base + i;
    k[j] = !ok[j] ? 0u : (first ? sortable_u32(keys[g]) : src_k[g]);
    ix[j] = !ok[j] ? 0 : (first ? base + i : src_i[g]);
  }
  count_digits(k, ok, kItems, shift, cnt, peers);
  __syncthreads();
  // thread d: the tile's count of digit d, its local start, and the
  // digit's global start (the row's histogram scan plus earlier tiles)
  const int d = tid;
  int lstart;
  const int total = warp_starts<1>(cnt, kWarps, red, &lstart);
  uint32_t* lk = look + (size_t)r * look_stride;
  if (tile == 0)
    st_relaxed(&lk[d], kFlagPrefix | (uint32_t)total);
  else
    st_relaxed(&lk[(size_t)tile * kBins + d],
               kFlagAggregate | (uint32_t)total);
  const uint32_t* pr = part + (size_t)r * slices * kPasses * kBins
                       + pass * kBins + d;
  int count = 0;
#pragma unroll 8
  for (int sl = 0; sl < slices; ++sl)
    count += (int)pr[(size_t)sl * kPasses * kBins];
  const int hstart = block_excl_scan(count, red);
  // decoupled look-back: sum the earlier tiles' counts of digit d, kLookBatch
  // words at a time, down to the first inclusive prefix; tile 0 always
  // publishes one, and a word still 0 is loaded again
  int before = 0;
  for (int t = tile - 1; t >= 0;) {
    uint32_t v[kLookBatch];
#pragma unroll
    for (int k = 0; k < kLookBatch; ++k)
      v[k] = t - k >= 0 ? ld_relaxed(&lk[(size_t)(t - k) * kBins + d]) : 0u;
    int k = 0;
    bool prefix = false;
    for (; k < kLookBatch && t - k >= 0; ++k) {
      if (v[k] == 0) break;               // not published yet
      before += (int)(v[k] & kCountMask);
      if (v[k] & kFlagPrefix) { prefix = true; break; }
    }
    if (prefix) break;
    t -= k;
  }
  if (tile > 0)
    st_relaxed(&lk[(size_t)tile * kBins + d],
               kFlagPrefix | (uint32_t)(before + total));
  delta[d] = hstart + before - lstart;
  __syncthreads();
  scatter_digits(k, ix, ok, peers, kItems, shift, cnt, skey, sidx);
  __syncthreads();
  for (int p = tid; p < len; p += kSweepThreads) {
    const uint32_t u = skey[p];
    const size_t g = row + p + delta[(u >> shift) & 0xff];
    if (last) {
      const size_t q = row + sidx[p];
      ok_out[g] = from_sortable_u32(u);
      ov[g] = vals[q];
      of[g] = flags[q];
    } else {
      dst_k[g] = u;
      dst_i[g] = sidx[p];
    }
  }
}

long long sweep_tiles(long long n) {
  return (n + kSweepTile - 1) / kSweepTile;
}

template <int kThreads>
cudaError_t launch_rows(const float* keys, const int* vals, const int* flags,
                        float* ok, int* ov, int* of, long long rows, int n,
                        cudaStream_t st) {
  const size_t smem = (size_t)n * 8 + (size_t)(kThreads / 32) * kBins * 4;
  if (smem > 32 * 1024) {   // with the static part, past the 48 KB default
    const cudaError_t err = cudaFuncSetAttribute(
        row_sort_kernel<kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  row_sort_kernel<kThreads><<<(unsigned)rows, kThreads, smem, st>>>(
      keys, vals, flags, ok, ov, of, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 words of workspace bitonic_launch needs for [rows, n]: for rows
// past one CTA, two ping-pong (u32 key, index) planes, then the slice
// histograms, and the look-back words and tile counters of every pass;
// none otherwise.
long long bitonic_ws_ints(long long rows, long long n) {
  if (n <= kRowTile) return 0;
  const long long slices = (n + kHistTile - 1) / kHistTile;
  return rows * (4 * n + slices * kPasses * kBins
                 + kPasses * sweep_tiles(n) * kBins + kPasses);
}

// Sorts each row of [rows, n] keys/vals/flags into ok/ov/of.  ws holds
// bitonic_ws_ints(rows, n) int32 words.  Returns the CUDA error of the
// launches (0 = success).
int bitonic_launch(const float* keys, const int* vals, const int* flags,
                   float* ok, int* ov, int* of, int* ws, long long rows,
                   long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = (int)n;
  if (N <= kRowTile) {
    // 128 threads a row where the rows fill the card (less per-CTA work),
    // more where few rows leave SMs idle (shorter per-row latency)
    const cudaError_t err =
        N <= kRowTile / 4 && rows >= kManyRows
            ? launch_rows<128>(keys, vals, flags, ok, ov, of, rows, N, st)
        : N <= kRowTile / 2
            ? launch_rows<256>(keys, vals, flags, ok, ov, of, rows, N, st)
            : launch_rows<512>(keys, vals, flags, ok, ov, of, rows, N, st);
    return (int)err;
  }
  const long long tiles = sweep_tiles(n);
  const int slices = (N + kHistTile - 1) / kHistTile;
  const size_t plane = (size_t)rows * N;
  uint32_t* pk[2] = {(uint32_t*)ws, (uint32_t*)ws + 2 * plane};
  int* pi[2] = {ws + plane, ws + 3 * plane};
  // then per row: part [slices][kPasses][kBins]; look [kPasses][tiles]
  // [kBins] and ctr [kPasses] together, zeroed by hist_kernel
  const int part_stride = slices * kPasses * kBins;
  const int look_stride = (int)(kPasses * tiles * kBins + kPasses);
  uint32_t* part = (uint32_t*)ws + 4 * plane;
  uint32_t* look = part + (size_t)rows * part_stride;
  cudaError_t err;
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int nr = (int)(rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY);
    const size_t off = (size_t)r0 * N;
    uint32_t* lk = look + r0 * look_stride;
    int* ctr = (int*)(lk + kPasses * tiles * kBins);
    hist_kernel<<<dim3(slices, nr), kHistThreads, 0, st>>>(
        keys + off, part + r0 * part_stride, lk, look_stride, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    for (int pass = 0; pass < kPasses; ++pass) {
      const bool first = pass == 0, last = pass == kPasses - 1;
      const int src = (pass + 1) & 1, dst = pass & 1;
      sweep_kernel<<<dim3((unsigned)tiles, nr), kSweepThreads, 0, st>>>(
          keys + off, vals + off, flags + off,
          first ? nullptr : pk[src] + off, first ? nullptr : pi[src] + off,
          last ? nullptr : pk[dst] + off, last ? nullptr : pi[dst] + off,
          ok + off, ov + off, of + off, part + r0 * part_stride, slices,
          lk + (size_t)pass * tiles * kBins, ctr + pass, N, pass,
          look_stride, look_stride);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

const char* bitonic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
