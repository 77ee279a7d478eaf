// merge_path.cuh — the co-rank search of a merge path, shared by K1
// (merge_consume.cu) and K3's head (lane_tick.cu).
//
// Merging sorted a[0, n) and b[0, m) with ties a-first puts a[i] at
// i + #{b < a[i]} and b[j] at j + #{a <= b[j]}.  The co-rank of diagonal d
// is the number of a-elements among the first d outputs: the first i in
// [max(0, d - m), min(d, n)) with a[i] > b[d - i - 1], or the end of that
// range.  Keys compare as floats (-0.0 ties 0.0).  The arrays are read
// through accessors, callables int -> float, so a caller can merge against
// a virtual array (K3's small-add window) as well as a pointer.
#pragma once

namespace merge_path {

// A plain array as an accessor.
struct Ptr {
  const float* p;
  __device__ __forceinline__ float operator()(int i) const { return p[i]; }
};

// The co-rank of diagonal d, by one thread.
template <class KA, class KB>
__device__ __forceinline__ int corank(const KA& a, int n, const KB& b, int m,
                                      int d) {
  int lo = d - m > 0 ? d - m : 0, hi = d < n ? d : n;
  while (lo < hi) {
    const int i = (lo + hi) >> 1;
    if (a(i) <= b(d - i - 1)) lo = i + 1; else hi = i;
  }
  return lo;
}

// The co-rank of diagonal d, by a whole warp (every lane calls with the
// same arguments and gets the answer): each round probes the last position
// of 32 equal segments at once, so a range of r positions takes about
// log32(r) rounds of loads instead of log2(r).
template <class KA, class KB>
__device__ __forceinline__ int corank_warp(const KA& a, int n, const KB& b,
                                           int m, int d) {
  const int lane = threadIdx.x & 31;
  int lo = d - m > 0 ? d - m : 0, hi = d < n ? d : n;
  // invariant: positions below lo take a, position hi (if < n) does not
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;
    const bool take = p < hi && a(p) <= b(d - p - 1);
    const int c = __popc(__ballot_sync(0xffffffffu, take));
    const int top = lo + (c + 1) * step - 1;
    lo = min(lo + c * step, hi);
    hi = min(top, hi);
  }
  const int p = lo + lane;
  const bool take = p < hi && a(p) <= b(d - p - 1);
  return lo + __popc(__ballot_sync(0xffffffffu, take));
}

}  // namespace merge_path
