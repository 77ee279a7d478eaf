// bitonic.cu — K2, the stable row co-sort of (keys, vals, flags), hand-written
// for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/bitonic.py::bitonic_sort_kvf (its pallas_call at :89, the
// network _sort_network :59).  Unlike that network this sort is stable: it
// sorts (u32-mapped key, row index) pairs, which are all distinct, so the
// network yields the one stable order — the stable argsort on the u32 map
// (-0.0 before 0.0) that the port's plain version computes, bit for bit, at
// any row length (not only powers of two).
//
//   1. tile_sort_kernel   grid (tiles, rows): a bitonic network over the
//                         pairs of one tile of at most kTile keys, in shared
//                         memory.  A row that fits one tile gathers its keys,
//                         vals and flags straight to the output.
//   2. merge_pass_kernel  grid (n / 256, rows), only for rows past kTile:
//                         merges sorted runs pairwise through a global
//                         workspace, each element placed at its own rank plus
//                         its rank in the other run (a binary search; the
//                         pairs are distinct, so no tie rule is needed).  The
//                         last pass gathers the outputs.
//
// Bound on this card: bytes.  The function reads keys, vals and flags once
// and writes them once, 24 bytes per element: 25.2 MB, about 7.5 us at
// 3.35 TB/s, for [1024, 1024] rows.  The network's O(n log^2 n) compare-
// exchanges run in shared memory, so global memory is read once and written
// once for rows up to kTile; a longer row pays 16 bytes per element for each
// merge pass.  This kernel is right first: its network synchronises the CTA
// at every stage, and one CTA sorts a row.  A radix sort by digits, or warp-
// level networks in registers, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16384;        // keys per shared-memory tile (128 KB)
constexpr int kMergeThreads = 256;
constexpr long long kMaxGridY = 65535;

__device__ __forceinline__ uint32_t sortable_u32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool pair_less(uint32_t ka, int ia, uint32_t kb,
                                          int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Sorts keys [base, base + len) of one row as (u32 key, row index) pairs,
// padded to P (a power of two) with (0xffffffff, n + s) pairs that order
// after every real pair.
__global__ void __launch_bounds__(1024) tile_sort_kernel(
    const float* keys, const int* vals, const int* flags, float* ok, int* ov,
    int* of, uint32_t* wk, int* wi, int n, int T, int P, int direct) {
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;
  int* sidx = reinterpret_cast<int*>(smem + P);
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = (size_t)blockIdx.y * n;
  const int base = blockIdx.x * T;
  const int len = min(T, n - base);
  for (int s = tid; s < P; s += nt) {
    skey[s] = s < len ? sortable_u32(keys[row + base + s]) : 0xffffffffu;
    sidx[s] = s < len ? base + s : n + s;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += nt) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint32_t ki = skey[i], kj = skey[j];
        const int ii = sidx[i], ij = sidx[j];
        // ascending where bit `size` of i is clear
        if (pair_less(kj, ij, ki, ii) == ((i & size) == 0)) {
          skey[i] = kj; skey[j] = ki; sidx[i] = ij; sidx[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  if (direct) {
    for (int p = tid; p < len; p += nt) {
      const size_t q = row + sidx[p];
      ok[row + p] = keys[q]; ov[row + p] = vals[q]; of[row + p] = flags[q];
    }
  } else {
    for (int p = tid; p < len; p += nt) {
      wk[row + base + p] = skey[p];
      wi[row + base + p] = sidx[p];
    }
  }
}

// Merges the sorted runs [r*w, (r+1)*w) of each row pairwise into runs of 2w.
__global__ void __launch_bounds__(kMergeThreads) merge_pass_kernel(
    const uint32_t* sk, const int* si, uint32_t* dk, int* di, int n, int w,
    const float* keys, const int* vals, const int* flags, float* ok, int* ov,
    int* of, int last) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const size_t row = (size_t)blockIdx.y * n;
  const uint32_t key = sk[row + p];
  const int idx = si[row + p];
  const int lo0 = p / (2 * w) * (2 * w);
  const int mid = min(lo0 + w, n), hi0 = min(lo0 + 2 * w, n);
  int lo, hi, own;
  if (p < mid) { lo = mid; hi = hi0; own = p - lo0; }
  else         { lo = lo0; hi = mid; own = p - mid; }
  const int first = lo;
  while (lo < hi) {   // #{other-run pairs below this one}
    const int m = (lo + hi) >> 1;
    if (pair_less(sk[row + m], si[row + m], key, idx)) lo = m + 1; else hi = m;
  }
  const size_t q = row + lo0 + own + (lo - first);
  if (last) {
    const size_t s = row + idx;
    ok[q] = keys[s]; ov[q] = vals[s]; of[q] = flags[s];
  } else {
    dk[q] = key; di[q] = idx;
  }
}

}  // namespace

extern "C" {

// int32 words of workspace bitonic_launch needs for [rows, n]: two ping-pong
// (key, index) buffers for rows past one tile, none otherwise.
long long bitonic_ws_ints(long long rows, long long n) {
  return n > kTile ? 4 * rows * n : 0;
}

// Sorts each row of [rows, n] keys/vals/flags into ok/ov/of.  ws holds
// bitonic_ws_ints(rows, n) int32 words.  Returns the CUDA error of the
// launches (0 = success).
int bitonic_launch(const float* keys, const int* vals, const int* flags,
                   float* ok, int* ov, int* of, int* ws, long long rows,
                   long long n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int N = (int)n;
  const bool direct = N <= kTile;
  const int T = direct ? N : kTile;
  int P = 1;
  while (P < T) P <<= 1;
  const int threads = P / 2 < 32 ? 32 : (P / 2 > 1024 ? 1024 : P / 2);
  const size_t smem = (size_t)P * 8;
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + T - 1) / T;
  const size_t plane = (size_t)rows * N;
  uint32_t* wk[2] = {(uint32_t*)ws, (uint32_t*)ws + plane};
  int* wi[2] = {ws + 2 * plane, ws + 3 * plane};
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int nr = (int)(rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY);
    const size_t off = (size_t)r0 * N;
    const float* k = keys + off; const int* v = vals + off;
    const int* f = flags + off;
    float* o_k = ok + off; int* o_v = ov + off; int* o_f = of + off;
    if (direct) {
      tile_sort_kernel<<<dim3(1, nr), threads, smem, st>>>(
          k, v, f, o_k, o_v, o_f, nullptr, nullptr, N, T, P, 1);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      continue;
    }
    tile_sort_kernel<<<dim3(tiles, nr), threads, smem, st>>>(
        k, v, f, o_k, o_v, o_f, wk[0] + off, wi[0] + off, N, T, P, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int cur = 0;
    for (int w = T; w < N; w *= 2) {
      const int last = 2 * (long long)w >= N;
      merge_pass_kernel<<<dim3((N + kMergeThreads - 1) / kMergeThreads, nr),
                          kMergeThreads, 0, st>>>(
          wk[cur] + off, wi[cur] + off, wk[cur ^ 1] + off, wi[cur ^ 1] + off,
          N, w, k, v, f, o_k, o_v, o_f, last);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      cur ^= 1;
    }
  }
  return (int)cudaGetLastError();
}

const char* bitonic_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
