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
//   merge_kernel  grid (ceil((n+m) / kTileOut), B): each CTA binary-searches
//                 the co-rank of its two output diagonals in global memory
//                 (merge_path.cuh, shared with K3's head),
//                 loads the keys between them into shared memory, lets each
//                 thread find its own co-rank there and merge kItems outputs
//                 serially (as source indices), then stores keys, vals and
//                 flags coalesced.
//
// Ties go a-first and keys compare as floats (-0.0 ties 0.0), so a[i] lands
// at i + #{b < a[i]} and b[j] at j + #{a <= b[j]}: the co-rank gather merge of
// the port's plain version, bit for bit.  Every value is copied, so any int32
// payload and any length work.
//
// Bound on this card: bytes.  It reads 12 bytes per input element and writes
// 12 per output: 3.17 MB (0.95 us at 3.35 TB/s) for 131072 + 1024, 25.2 MB
// (7.5 us) for 1,048,576 + 1024.  The design reads each key from global memory
// about twice (the tile load, the store's gather of vals and flags reads the
// rest once) and writes each output once, in order; the co-rank searches cost
// log(n) reads per CTA.  Loading vals and flags through shared memory with
// cp.async or TMA, and persistent CTAs, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTileOut = kThreads * kItems;   // outputs per CTA
constexpr long long kMaxGridY = 65535;

using merge_path::corank;
using merge_path::Ptr;

__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* ak, const int* av, const int* af, const float* bk,
    const int* bv, const int* bf, float* ok, int* ov, int* of, int n, int m) {
  __shared__ float sk[kTileOut];
  __shared__ int src[kTileOut];
  __shared__ int cut[2];
  const int tid = threadIdx.x;
  const size_t ra = (size_t)blockIdx.y * n, rb = (size_t)blockIdx.y * m;
  const int total = n + m;
  const size_t ro = (size_t)blockIdx.y * total;
  const int d0 = blockIdx.x * kTileOut;
  const int d1 = min(d0 + kTileOut, total);
  if (tid < 2)
    cut[tid] = corank(Ptr{ak + ra}, n, Ptr{bk + rb}, m, tid ? d1 : d0);
  __syncthreads();
  const int i0 = cut[0], j0 = d0 - cut[0];
  const int na = cut[1] - cut[0], len = d1 - d0, nb = len - na;
  for (int s = tid; s < len; s += kThreads)
    sk[s] = s < na ? ak[ra + i0 + s] : bk[rb + j0 + s - na];
  __syncthreads();
  const int ld = tid * kItems;
  if (ld < len) {
    int i = corank(Ptr{sk}, na, Ptr{sk + na}, nb, ld);
    int j = ld - i;
    const int end = min(ld + kItems, len);
    for (int q = ld; q < end; ++q) {
      const bool take_a = j >= nb || (i < na && sk[i] <= sk[na + j]);
      src[q] = take_a ? i++ : na + j++;
    }
  }
  __syncthreads();
  for (int s = tid; s < len; s += kThreads) {
    const int q = src[s];
    int v, f;
    if (q < na) {
      const size_t g = ra + i0 + q;
      v = av[g]; f = af[g];
    } else {
      const size_t g = rb + j0 + (q - na);
      v = bv[g]; f = bf[g];
    }
    ok[ro + d0 + s] = sk[q]; ov[ro + d0 + s] = v; of[ro + d0 + s] = f;
  }
}

}  // namespace

extern "C" {

// Merges a [B, n] and b [B, m] row by row into [B, n+m].  Returns the CUDA
// error of the launches (0 = success).
int merge_consume_launch(const float* ak, const int* av, const int* af,
                         const float* bk, const int* bv, const int* bf,
                         float* ok, int* ov, int* of, long long rows,
                         long long n, long long m, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = n + m;
  const int tiles = (int)((total + kTileOut - 1) / kTileOut);
  for (long long r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int nr = (int)(rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY);
    const size_t oa = (size_t)r0 * n, ob = (size_t)r0 * m;
    const size_t oo = (size_t)r0 * total;
    merge_kernel<<<dim3(tiles, nr), kThreads, 0, st>>>(
        ak + oa, av + oa, af + oa, bk + ob, bv + ob, bf + ob, ok + oo,
        ov + oo, of + oo, (int)n, (int)m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* merge_consume_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
