// merge_consume.cu — K1, the rank merge of two sorted (key, val, flag)
// streams, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// src/repro/kernels/merge_consume.py::merge_sorted_kvf (its pallas_call at
// :119, body _kernel :63 with _count_less :41 and _count_leq :52).  That
// kernel counts ranks into VMEM and builds each output tile as a one-hot f32
// MXU matmul, which bounds payloads to |val| < 2^24, needs n+m to be a
// multiple of the tile, and writes -0.0 as 0.0.  This one is a merge path:
//
//   merge_kernel<ITEMS>  grid rows x tiles, flattened into one dimension
//       (the launch plan, merge_consume.py::launch_plan, picks ITEMS so that
//       a large merge puts at least two CTAs on every SM).  Each CTA owns
//       kThreads * ITEMS outputs of one row:
//       1. two warps search the co-ranks of its two output diagonals at
//          once, a warp each (merge_path::corank_warp: 32 probes a round, so
//          log32 rounds of loads: two at the shapes the port merges);
//       2. the keys, vals and flags of both streams between the diagonals
//          go into shared memory by cp.async (16 bytes a thread where the
//          inputs are 16-byte aligned, 4 otherwise), the keys as one group
//          and vals and flags as a second: every input element is read from
//          device memory once, in one round trip;
//       3. once the keys have landed, each thread finds its own co-rank in
//          shared memory and merges its ITEMS outputs as the staged words
//          they come from, while vals and flags still land;
//       4. the tile is gathered from the windows and stored coalesced, 16
//          bytes a thread where the output offset is 16-byte aligned.
//
// Ties go a-first and keys compare as floats (-0.0 ties 0.0), so a[i] lands
// at i + #{b < a[i]} and b[j] at j + #{a <= b[j]}: the co-rank gather merge of
// the port's plain version, bit for bit.  Every value is copied, so any int32
// payload and any length work.
//
// Bound on this card: bytes.  It reads 12 bytes per input element and writes
// 12 per output: 3.17 MB (0.95 us at 3.35 TB/s) for 131072 + 1024, 25.2 MB
// (7.5 us) for 1,048,576 + 1024.  This design moves each byte once (up to 3
// words either side of a window again, for alignment).  Below a few MB a call
// is bound by latency instead: about 2 us of launch and 3 dependent round
// trips (two co-rank rounds, the staged window) before the store; a CTA
// spends about 2.4 us from the first start to the last store (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 16;      // staged words beyond a tile: alignment slack

using merge_path::corank;
using merge_path::corank_warp;
using merge_path::Ptr;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 16-byte copy of which only the first `bytes` are read (the rest of
// the destination is zero-filled).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are still
// in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Words of shared memory the window [g0, g0 + count) of an array takes when
// staged: whole 16-byte chunks if vec, else the window itself.
__device__ __forceinline__ int staged_words(long long g0, int count,
                                            bool vec) {
  if (!vec || count == 0) return count;
  return (int)(((g0 + count + 3) & ~3LL) - (g0 & ~3LL));
}

// Stage the window [g0, g0 + count) of p (an array of `limit` words) into
// dst by cp.async; returns the word of dst that holds element g0.  Chunks
// start at 16-byte boundaries of p, which vec promises are aligned, and stop
// at the array's end.
__device__ __forceinline__ int stage(void* dst, const void* p, long long g0,
                                     int count, long long limit, bool vec) {
  const int* src = static_cast<const int*>(p);
  int* out = static_cast<int*>(dst);
  if (count == 0) return 0;
  if (!vec) {
    for (int s = threadIdx.x; s < count; s += blockDim.x)
      cp_async4(out + s, src + g0 + s);
    return 0;
  }
  const long long lo = g0 & ~3LL, hi = (g0 + count + 3) & ~3LL;
  for (long long c = lo + 4LL * threadIdx.x; c < hi; c += 4LL * blockDim.x) {
    const long long left = limit - c;
    cp_async16(out + (c - lo), src + c, left >= 4 ? 16 : (int)left * 4);
  }
  return (int)(g0 - lo);
}

template <int ITEMS>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ ak, const int* __restrict__ av,
    const int* __restrict__ af, const float* __restrict__ bk,
    const int* __restrict__ bv, const int* __restrict__ bf,
    float* __restrict__ ok, int* __restrict__ ov, int* __restrict__ of,
    long long rows, int n, int m, int tiles, bool vec) {
  constexpr int kTile = kThreads * ITEMS;
  __shared__ __align__(16) float sk[kTile + kPad];
  __shared__ __align__(16) int sv[kTile + kPad];
  __shared__ __align__(16) int sf[kTile + kPad];
  __shared__ int src[kTile];
  __shared__ int cut[2];
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long row = blockIdx.x / tiles;
  const int tile = (int)(blockIdx.x - row * tiles);
  const int total = n + m;
  const long long ra = row * n, rb = row * m, ro = row * total;
  const int d0 = tile * kTile;
  const int d1 = min(d0 + kTile, total);

  // 1. the co-ranks of the tile's two diagonals, a warp each
  if (warp < 2) {
    const int c = corank_warp(Ptr{ak + ra}, n, Ptr{bk + rb}, m,
                              warp ? d1 : d0);
    if ((tid & 31) == 0) cut[warp] = c;
  }
  __syncthreads();
  const int i0 = cut[0], j0 = d0 - cut[0];
  const int na = cut[1] - cut[0], len = d1 - d0, nb = len - na;

  // 2. both windows into shared memory, a's then b's, in one round trip:
  //    the keys as one group of copies, vals and flags as a second, which
  //    lands while the keys are merged
  const long long ga = ra + i0, gb = rb + j0;
  const long long la = rows * n, lb = rows * m;
  const int wa = staged_words(ga, na, vec);
  const int oa = stage(sk, ak, ga, na, la, vec);
  const int ob = wa + stage(sk + wa, bk, gb, nb, lb, vec);
  cp_async_commit();
  stage(sv, av, ga, na, la, vec);
  stage(sf, af, ga, na, la, vec);
  stage(sv + wa, bv, gb, nb, lb, vec);
  stage(sf + wa, bf, gb, nb, lb, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 3. each thread's ITEMS outputs, merged in shared memory as the words
  //    of the staged windows they come from
  const int ld = tid * ITEMS;
  if (ld < len) {
    const float* ka = sk + oa;
    const float* kb = sk + ob;
    int i = corank(Ptr{ka}, na, Ptr{kb}, nb, ld);
    int j = ld - i;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (ld + q < len) {
        const bool take_a = j >= nb || (i < na && ka[i] <= kb[j]);
        src[ld + q] = take_a ? oa + i++ : ob + j++;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 4. the tile out, gathered from the windows: scalars up to a 16-byte
  //    boundary, then vectors
  const long long go = ro + d0;
  const int head = min(len, (int)((4 - (go & 3)) & 3));
  for (int s = tid; s < head; s += kThreads) {
    const int q = src[s];
    ok[go + s] = sk[q];
    ov[go + s] = sv[q];
    of[go + s] = sf[q];
  }
  const int vecs = (len - head) >> 2;
  for (int v = tid; v < vecs; v += kThreads) {
    const int s = head + 4 * v;
    const int q0 = src[s], q1 = src[s + 1], q2 = src[s + 2], q3 = src[s + 3];
    *reinterpret_cast<float4*>(ok + go + s) =
        make_float4(sk[q0], sk[q1], sk[q2], sk[q3]);
    *reinterpret_cast<int4*>(ov + go + s) =
        make_int4(sv[q0], sv[q1], sv[q2], sv[q3]);
    *reinterpret_cast<int4*>(of + go + s) =
        make_int4(sf[q0], sf[q1], sf[q2], sf[q3]);
  }
  for (int s = head + 4 * vecs + tid; s < len; s += kThreads) {
    const int q = src[s];
    ok[go + s] = sk[q];
    ov[go + s] = sv[q];
    of[go + s] = sf[q];
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// Merges a [B, n] and b [B, m] row by row into [B, n+m] with the launch
// plan's `tile` outputs a CTA (512 or 2048) and `tiles` CTAs a row.
// The outputs must be 16-byte aligned (fresh allocations are).  Returns
// the CUDA error of the launch (0 = success); a plan that does not cover
// the rows is refused as cudaErrorInvalidValue.
int merge_consume_launch(const float* ak, const int* av, const int* af,
                         const float* bk, const int* bv, const int* bf,
                         float* ok, int* ov, int* of, long long rows,
                         long long n, long long m, long long tile,
                         long long tiles, void* stream) {
  const long long total = n + m;
  const long long grid = rows * tiles;
  if (rows < 1 || total < 1 || total >= (1LL << 31) || tiles < 1 ||
      tiles * tile < total || (tiles - 1) * tile >= total ||
      grid > 0x7fffffffLL || !aligned16(ok) || !aligned16(ov) ||
      !aligned16(of))
    return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(ak) && aligned16(av) && aligned16(af) &&
                   aligned16(bk) && aligned16(bv) && aligned16(bf);
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g((unsigned)grid);
  switch (tile) {
    case kThreads * 8:
      merge_kernel<8><<<g, kThreads, 0, st>>>(ak, av, af, bk, bv, bf, ok, ov,
                                             of, rows, (int)n, (int)m,
                                             (int)tiles, vec);
      break;
    case kThreads * 2:
      merge_kernel<2><<<g, kThreads, 0, st>>>(ak, av, af, bk, bv, bf, ok, ov,
                                             of, rows, (int)n, (int)m,
                                             (int)tiles, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* merge_consume_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
