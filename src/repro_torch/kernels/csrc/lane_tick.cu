// lane_tick.cu — every lane's hot queue tick, hand-written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas megakernel
// src/repro/kernels/lane_tick.py::fused_tick_mid (its pallas_call at :185,
// body _mid_kernel at :80).  Per lane it computes, bit for bit, what that
// kernel computes:
//
//   _tick_head(adds_sorted=True) -> _pass_combine -> _pass_scatter
//   -> _tick_preds -> _repair_move (through the jnp branch of
//   extract_k_bucketed: per-row stable sorts + run-window gathers)
//
// The add batch arrives presorted (the wrapper's stable sort on the u32
// map).  Three launches per tick, all on the caller's stream:
//
//   1. head_kernel    grid (T + 1, L): per lane, T tile CTAs and one
//                     control CTA.  Every CTA first recomputes the lane's
//                     scalars from the A-long add batch (counts, the
//                     consumed length s, the spill), so no CTA waits on
//                     another.  The combine is a merge path (merge_path.cuh)
//                     of the sequential part with the virtual small-add
//                     window: tile t owns output slots [t*TW, (t+1)*TW) of
//                     [consumed prefix | new sequential part], finds its two
//                     diagonals' co-ranks with warp-wide searches, merges its
//                     window in shared memory (ties a-first) and writes each
//                     element straight to its place, the removal stream or
//                     the new sequential part; tiles past the merged length
//                     only fill the INF/EMPTY tail.  The control CTA merges
//                     the spill window itself, builds the par-bound batch
//                     [spill | large] in shared memory, and runs the scatter
//                     decision, the predicates and the moveHead bookkeeping.
//   2. rows_kernel    grid (NB, L), one CTA per bucket row: builds the
//                     post-scatter row; for a lane that takes moveHead it
//                     also sorts the row (bitonic network over (u32 key,
//                     slot) pairs in shared memory), writes the selected run
//                     prefix into the extraction buffer and shifts the
//                     survivors left.
//   3. move_kernel    grid (L): serves the moveHead shortfall and writes the
//                     fresh sequential part from the extraction buffer.
//
// Keys compare as floats in merges, searches and predicates (-0.0 ties
// 0.0); sorts order by the u32 map (-0.0 before 0.0), and minima take -0.0
// below 0.0, as the reference does.
// No |val| < 2^24 bound, no power-of-two length and no tile divisibility:
// those belong to the TPU's one-hot MXU merge, not to this function.
//
// Bound on this card: the work is data movement.  Per tick a lane reads its
// state and writes it back (sequential part 8*seq_cap bytes, bucket store
// 8*NB*BCAP bytes each way, plus the batch): about 0.5 MB at the w4096
// geometry and about 18 MB at PRODUCTION, i.e. about 5.5 us of HBM traffic
// at 3.35 TB/s; one launch's latency (a few us) is below that.  The head
// reads and writes the sequential part once, spread over (seq_cap + r_max)
// / TW CTAs per lane, with no global merge buffer.  The rows and move
// launches, and updating the state in place, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kEmptyVal = -1;
constexpr int kLaneWs = 16;          // int32 scalars per lane in lane_ws
constexpr int kHeadThreads = 512;
constexpr int kMoveThreads = 1024;

// lane_ws slots
enum { WS_APPLIED = 0, WS_MOVE, WS_SERVED, WS_KEXTRACT, WS_K, WS_NLEN,
       WS_MOVE_OFF, WS_PAR_COUNT };

struct Args {
  // inputs, [L, ...] each
  const float* seq_keys; const int* seq_vals; const int* seq_len;
  const float* buckets; const int* bvals; const int* bcounts;
  const float* splitters; const float* par_min; const int* par_count;
  const float* min_value; const float* last_seq; const int* detach_n;
  const int* ins_since_move; const int* quiet_ticks;
  const float* ak; const int* av; const int* am; const int* grant;
  // outputs, in the wrapper's _out_layout order
  float* nsk; int* nsv; int* new_len;
  float* pbk; int* pbv; int* pbc; float* psp; float* pmin; int* pcnt;
  float* rmk; int* rmv; int* rmc; float* pendk; int* pendv;
  int* need_combine; int* need_scatter; int* need_rebal; int* need_move;
  int* r2; int* move_off; int* detach_arg; int* need_chop;
  int* n_imm; int* n_upc; int* n_rm_seq; int* n_addseq; int* n_par_adds;
  int* spilled; int* n_rm_par; int* n_drop_rep;
  int* detach_out; int* ins_out; int* quiet_out;
  // workspace
  int* seg_start; int* new_counts; int* offs;
  int* nsel; float* rowmin; float* selk; int* selv; int* lane_ws;
  // geometry and policy; TW output slots per head tile, T head tiles
  int L, A, R, SC, NB, BC, K, spill_thr, chop_patience, detach_min,
      detach_max, halve_thr, double_thr, TW, T;
};

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t sortable_u32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// The minimum of two NaN-free keys as the reference takes it (XLA's
// minimum): -0.0 orders below 0.0.
__device__ __forceinline__ float key_min(float a, float b) {
  return (a < b || (a == b && signbit(a))) ? a : b;
}

// ---- block reductions (every thread of the block must call) -------------

__device__ int block_sum(int x, int* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  int t = 0;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ float block_min(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    x = key_min(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  float t = f_inf();
  for (int i = 0; i < nw; ++i) t = key_min(t, red[i]);
  return t;
}

// Exclusive prefix sum across the block; *total gets the block's sum.
__device__ int block_excl_scan(int x, int* red, int* total) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = (blockDim.x + 31) >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  __syncthreads();
  if (lane == 31) red[w] = inc;
  __syncthreads();
  int before = 0, t = 0;
  for (int i = 0; i < nw; ++i) {
    if (i < w) before += red[i];
    t += red[i];
  }
  *total = t;
  return before + inc - x;
}

// Block-wide fill of p[i0, i1) with one 32-bit pattern, 16-byte stores
// where aligned.
__device__ void fill_u32(uint32_t* p, int i0, int i1, uint32_t bits) {
  if (i0 >= i1) return;
  const int skew = (int)((reinterpret_cast<uintptr_t>(p + i0) >> 2) & 3);
  const int a0 = min(i1, i0 + ((4 - skew) & 3));
  for (int i = i0 + threadIdx.x; i < a0; i += blockDim.x) p[i] = bits;
  const int nvec = (i1 - a0) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + a0);
  for (int q = threadIdx.x; q < nvec; q += blockDim.x)
    v[q] = make_uint4(bits, bits, bits, bits);
  for (int i = a0 + 4 * nvec + threadIdx.x; i < i1; i += blockDim.x)
    p[i] = bits;
}

// ---- the lane's add batch, as closed-form index arithmetic ---------------

struct Adds {
  const float* aks_s;   // shared memory: am ? ak : INF
  const int* avs_s;     // shared memory: am ? av : EMPTY
  int A, n_imm, n_small; float last;
  __device__ float aks(int i) const { return aks_s[i]; }
  __device__ int avs(int i) const { return avs_s[i]; }
  // _shift_left(ak, n_imm)
  __device__ float rem_k(int i) const {
    return i + n_imm < A ? aks(i + n_imm) : f_inf();
  }
  __device__ int rem_v(int i) const {
    return i + n_imm < A ? avs(i + n_imm) : kEmptyVal;
  }
  __device__ float small_k(int i) const {
    float k = rem_k(i);
    return k <= last ? k : f_inf();
  }
  __device__ int small_v(int i) const {
    return rem_k(i) <= last ? rem_v(i) : kEmptyVal;
  }
  // _shift_left(rem_k, n_small)
  __device__ float large_k(int i) const {
    return i + n_small < A ? rem_k(i + n_small) : f_inf();
  }
  __device__ int large_v(int i) const {
    return i + n_small < A ? rem_v(i + n_small) : kEmptyVal;
  }
};

// The small-add window as a merge-path accessor.
struct SmallKeys {
  Adds ad;
  __device__ float operator()(int j) const { return ad.small_k(j); }
};

// #{i < n : keys[i] < x} over a nondecreasing row
__device__ int count_less(const float* keys, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- launch 1: head, combine, scatter decision, predicates ---------------

// The lane's scalars, which every head CTA computes for itself.
struct Lane {
  int rmc, n_adds, n_imm, n_small, n_small_c, n_par_adds;
  bool combine;
  int s, spill_cnt, sp_start;   // consumed length, spill, kept length
};

// Loads the batch's sanitized keys and vals into shared memory and counts.
__device__ Lane lane_scalars(const Args& a, int l, Adds& ad, float* saks,
                             int* savs, int* red) {
  const int A = a.A, tid = threadIdx.x, nt = blockDim.x;
  const float INF = f_inf();
  Lane ln;
  ln.rmc = min(a.grant[l], a.R);
  const size_t row = (size_t)l * A;
  int c = 0;
  for (int i = tid; i < A; i += nt) {
    const bool in = a.am[row + i] != 0;
    saks[i] = in ? a.ak[row + i] : INF;
    savs[i] = in ? a.av[row + i] : kEmptyVal;
    c += in;
  }
  ln.n_adds = block_sum(c, red);          // also publishes saks, savs
  const float m0 = a.min_value[l];
  c = 0;
  for (int i = tid; i < A; i += nt) c += (ad.aks(i) <= m0) && (i < ln.n_adds);
  ln.n_imm = min(block_sum(c, red), ln.rmc);
  ad.n_imm = ln.n_imm;
  c = 0;
  for (int i = tid; i < A; i += nt) c += ad.rem_k(i) <= ad.last;
  ln.n_small = block_sum(c, red);
  ad.n_small = ln.n_small;
  int c1 = 0, c2 = 0;
  for (int i = tid; i < A; i += nt) {
    c1 += ad.large_k(i) < INF;
    c2 += ad.small_k(i) < INF;
  }
  ln.n_par_adds = block_sum(c1, red);
  ln.n_small_c = block_sum(c2, red);      // the combine's small count
  const int seq_len = a.seq_len[l];
  ln.combine = seq_len > 0 || ln.n_small > 0;
  ln.s = 0; ln.spill_cnt = 0; ln.sp_start = seq_len;
  if (ln.combine) {
    const int avail = seq_len + ln.n_small_c;
    ln.s = min(ln.rmc - ln.n_imm, avail);
    const int nl1 = avail - ln.s;
    ln.spill_cnt = max(0, nl1 - a.spill_thr);
    ln.sp_start = nl1 - ln.spill_cnt;
  }
  return ln;
}

// Merges output slots [d0, d1) of (seq part, small window), ties a-first,
// into mkeys/msrc: slot p holds key mkeys[msrc[p]], from seq slot c0 + q
// when q = msrc[p] < na, else from small slot j0 + q - na.  Returns na;
// *c0 gets the co-rank of d0.  Block-wide; d1 > d0.
__device__ int merge_window(const float* sk, int SC, const SmallKeys& b,
                            int A, int d0, int d1, float* mkeys, int* msrc,
                            int* cut, int* c0_out) {
  const int tid = threadIdx.x, nt = blockDim.x, w = tid >> 5;
  const merge_path::Ptr a{sk};
  if (w < 2) {
    const int c = merge_path::corank_warp(a, SC, b, A, w ? d1 : d0);
    if ((tid & 31) == 0) cut[w] = c;
  }
  __syncthreads();
  const int c0 = cut[0], len = d1 - d0, na = cut[1] - c0, nb = len - na;
  const int j0 = d0 - c0;
  for (int p = tid; p < len; p += nt)
    mkeys[p] = p < na ? sk[c0 + p] : b(j0 + p - na);
  __syncthreads();
  const int items = (len + nt - 1) / nt;
  const int ld = tid * items;
  if (ld < len) {
    int i = merge_path::corank(merge_path::Ptr{mkeys}, na,
                               merge_path::Ptr{mkeys + na}, nb, ld);
    int j = ld - i;
    const int end = min(ld + items, len);
    for (int q = ld; q < end; ++q) {
      const bool take_a = j >= nb || (i < na && mkeys[i] <= mkeys[na + j]);
      msrc[q] = take_a ? i++ : na + j++;
    }
  }
  __syncthreads();
  *c0_out = c0;
  return na;
}

// One head tile: output slots [u0, u0 + TW) of [consumed prefix (s) | new
// sequential part (SC)].
__device__ void head_tile(const Args& a, int l, const Lane& ln,
                          const SmallKeys& b, float* mkeys, int* msrc,
                          int* cut) {
  const int tid = threadIdx.x, nt = blockDim.x, SC = a.SC, s = ln.s;
  const int u0 = blockIdx.x * a.TW;
  const int u1 = min(u0 + a.TW, s + SC);
  if (u0 >= u1) return;
  const float* sk = a.seq_keys + (size_t)l * SC;
  const int* sv = a.seq_vals + (size_t)l * SC;
  float* nsk = a.nsk + (size_t)l * SC;
  int* nsv = a.nsv + (size_t)l * SC;
  if (!ln.combine) {
    for (int i = u0 + tid; i < u1; i += nt) { nsk[i] = sk[i]; nsv[i] = sv[i]; }
    return;
  }
  const int kept = s + ln.sp_start;            // merged slots that land
  const int d1 = min(u1, kept);
  if (d1 > u0) {
    int c0;
    const int na = merge_window(sk, SC, b, a.A, u0, d1, mkeys, msrc, cut,
                                &c0);
    const int j0 = u0 - c0;
    float* rmk = a.rmk + (size_t)l * a.R + ln.n_imm;
    int* rmv = a.rmv + (size_t)l * a.R + ln.n_imm;
    for (int p = tid; p < d1 - u0; p += nt) {
      const int q = msrc[p], d = u0 + p;
      const float k = mkeys[q];
      const int v = q < na ? sv[c0 + q] : b.ad.small_v(j0 + q - na);
      if (d < s) { rmk[d] = k; rmv[d] = v; }
      else { nsk[d - s] = k; nsv[d - s] = v; }
    }
  }
  const int f0 = max(u0, kept) - s, f1 = u1 - s;
  fill_u32(reinterpret_cast<uint32_t*>(nsk), f0, f1, 0x7f800000u);
  fill_u32(reinterpret_cast<uint32_t*>(nsv), f0, f1, (uint32_t)kEmptyVal);
}

// The control CTA: the par-bound batch, the rest of the removal stream,
// the scatter decision, predicates and moveHead bookkeeping.
__device__ void head_control(const Args& a, int l, const Lane& ln,
                             const SmallKeys& b, float* mkeys, int* msrc,
                             float* spk, int* cut, int* red, float* redf) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int A = a.A, R = a.R, SC = a.SC, NB = a.NB, BC = a.BC;
  const int M = SC + A;
  const float INF = f_inf();
  const Adds& ad = b.ad;
  const float* sk = a.seq_keys + (size_t)l * SC;
  const int* sv = a.seq_vals + (size_t)l * SC;
  const int* bcin = a.bcounts + (size_t)l * NB;
  const float* spl = a.splitters + (size_t)l * NB;
  float* rmk = a.rmk + (size_t)l * R;
  int* rmv = a.rmv + (size_t)l * R;
  float* pendk = a.pendk + (size_t)l * A;
  int* pendv = a.pendv + (size_t)l * A;
  int* seg_start = a.seg_start + (size_t)l * NB;
  int* new_counts = a.new_counts + (size_t)l * NB;
  int* offs = a.offs + (size_t)l * NB;
  int* nsel = a.nsel + (size_t)l * NB;
  int* ws = a.lane_ws + (size_t)l * kLaneWs;
  const bool combine = ln.combine;
  const int rmc = ln.rmc, n_imm = ln.n_imm, s = ln.s;
  const int spill_cnt = ln.spill_cnt, sp_start = ln.sp_start;

  // ---- combine: the consumed smalls, and the spill part of the batch ----
  int n_upc = 0, nv = 0;
  if (combine) {
    if (tid < 32) {
      const int c = merge_path::corank_warp(merge_path::Ptr{sk}, SC, b, A, s);
      if (tid == 0) cut[2] = s - c;   // smalls among the consumed prefix
    }
    // spill slot i is merged slot s + sp_start + i, INF past the seq part
    const int g0 = s + sp_start;
    nv = max(0, min(min(spill_cnt, A), min(SC - sp_start, M - g0)));
    if (nv > 0) {
      int c0;
      const int na = merge_window(sk, SC, b, A, g0, g0 + nv, mkeys, msrc,
                                  cut, &c0);
      const int j0 = g0 - c0;
      for (int p = tid; p < nv; p += nt) {
        const int q = msrc[p];
        spk[p] = mkeys[q];
        pendv[p] = q < na ? sv[c0 + q] : ad.small_v(j0 + q - na);
      }
    }
    __syncthreads();
    n_upc = cut[2];
  }
  // par-bound batch: [spill | large]
  for (int i = tid; i < A; i += nt) {
    if (i >= nv) {
      float k; int v;
      if (i < spill_cnt) { k = INF; v = kEmptyVal; }
      else { k = ad.large_k(i - spill_cnt); v = ad.large_v(i - spill_cnt); }
      spk[i] = k; pendv[i] = v;
    }
  }
  // removal stream: the eliminated prefix; the tiles write the consumed
  // merge prefix [n_imm, n_imm + s)
  for (int r = tid; r < R; r += nt) {
    if (combine && r >= n_imm && r - n_imm < s) continue;
    float k = INF; int v = kEmptyVal;
    if (r < rmc && r < n_imm) {
      k = ad.aks(min(r, A - 1));
      v = ad.avs(min(r, A - 1));
    }
    rmk[r] = k; rmv[r] = v;
  }
  __syncthreads();   // spk is read by every thread below
  for (int i = tid; i < A; i += nt) pendk[i] = spk[i];
  const int new_len = combine ? sp_start : a.seq_len[l];
  const int move_off = n_imm + s;
  const int n_rm_seq = s - n_upc;
  const int n_addseq = ln.n_small_c - n_upc;
  bool scatter = ln.n_par_adds > 0 || (combine && spill_cnt > 0);

  // ---- scatter: SL::addPar() segment append (the rows are written by
  // rows_kernel); an overflow discards it and asks for the rebalance ----
  float kmin = INF;
  int c = 0;
  for (int i = tid; i < A; i += nt) {
    const float k = spk[i];
    if (k < INF) { ++c; kmin = key_min(kmin, k); }
  }
  const int n_pend = block_sum(c, red);
  kmin = block_min(kmin, redf);
  float par_min = a.par_min[l];
  int par_count = a.par_count[l];
  bool applied = false, rebal = false;
  if (scatter) {
    c = 0;
    for (int bk = tid; bk < NB; bk += nt) {
      const int start = bk == 0 ? 0 : count_less(spk, A, spl[bk]);
      const int end = count_less(spk, A, bk + 1 < NB ? spl[bk + 1] : INF);
      const int nc = bcin[bk] + end - start;
      seg_start[bk] = start;
      new_counts[bk] = nc;
      c += nc > BC;
    }
    const bool overflow = block_sum(c, red) > 0;
    applied = !overflow;
    rebal = overflow;
    if (applied) {
      par_min = key_min(par_min, kmin);
      par_count += n_pend;
    }
  }

  // ---- predicates ----
  const int r2 = rmc - move_off;
  const int count_eff = par_count + (rebal ? n_pend : 0);
  const bool move = r2 > 0 && count_eff > 0;
  const int ins = a.ins_since_move[l] + n_addseq;
  const int d = a.detach_n[l];
  const int halved = max(a.detach_min, d / 2);
  const int doubled = min(a.detach_max, d * 2);
  const int nd = ins > a.halve_thr ? halved
               : (ins < a.double_thr ? doubled : d);
  int quiet = rmc > 0 ? 0 : a.quiet_ticks[l] + 1;
  const bool chop = quiet >= a.chop_patience && new_len > 0;
  if (chop) quiet = 0;

  // ---- moveHead bookkeeping (the rows and the serve come next) ----
  const bool move_sel = move && !rebal;
  int served = 0, k_extract = 0, k = 0;
  if (move_sel) {
    served = min(r2, par_count);
    k_extract = min(max(d, r2), par_count);
    k_extract = min(k_extract, served + a.spill_thr);
    c = 0;
    for (int bk = tid; bk < NB; bk += nt)
      c += applied ? new_counts[bk] : bcin[bk];
    const int total = block_sum(c, red);
    k = min(min(k_extract, total), a.K);
    int carry = 0;
    for (int base = 0; base < NB; base += nt) {
      const int bk = base + tid;
      const int cnt = bk < NB ? (applied ? new_counts[bk] : bcin[bk]) : 0;
      int chunk;
      const int off = carry + block_excl_scan(cnt, red, &chunk);
      if (bk < NB) {
        const int ns = min(max(k - off, 0), cnt);
        offs[bk] = off;
        nsel[bk] = ns;
        a.pbc[(size_t)l * NB + bk] = cnt - ns;
      }
      carry += chunk;
    }
  } else {
    for (int bk = tid; bk < NB; bk += nt)
      a.pbc[(size_t)l * NB + bk] = applied ? new_counts[bk] : bcin[bk];
  }
  for (int bk = tid; bk < NB; bk += nt) a.psp[(size_t)l * NB + bk] = spl[bk];

  if (tid == 0) {
    ws[WS_APPLIED] = applied;
    ws[WS_MOVE] = move_sel;
    ws[WS_SERVED] = served;
    ws[WS_KEXTRACT] = k_extract;
    ws[WS_K] = k;
    ws[WS_NLEN] = k_extract - served;
    ws[WS_MOVE_OFF] = move_off;
    ws[WS_PAR_COUNT] = par_count;
    a.new_len[l] = new_len;
    a.pmin[l] = par_min;          // move_kernel replaces both on moveHead
    a.pcnt[l] = par_count;
    a.rmc[l] = rmc;
    a.need_combine[l] = combine;
    a.need_scatter[l] = scatter;
    a.need_rebal[l] = rebal;
    a.need_move[l] = move;
    a.r2[l] = r2;
    a.move_off[l] = move_off;
    a.detach_arg[l] = d;
    a.need_chop[l] = chop;
    a.n_imm[l] = n_imm;
    a.n_upc[l] = combine ? n_upc : 0;
    a.n_rm_seq[l] = combine ? n_rm_seq : 0;
    a.n_addseq[l] = combine ? n_addseq : 0;
    a.n_par_adds[l] = ln.n_par_adds;
    a.spilled[l] = combine && spill_cnt > 0;
    a.n_rm_par[l] = move_sel ? served : 0;
    a.n_drop_rep[l] = 0;
    a.detach_out[l] = move ? nd : d;
    a.ins_out[l] = move ? 0 : ins;
    a.quiet_out[l] = quiet;
  }
}

// Dynamic shared memory of head_kernel, in 32-bit words: the batch's
// sanitized keys and vals [2 * A], a merge window's keys and sources
// [2 * max(A, TW)], the par-bound batch [A].
__host__ __device__ inline size_t head_smem_words(int A, int TW) {
  return (size_t)3 * A + 2 * (size_t)(A > TW ? A : TW);
}

__global__ void __launch_bounds__(kHeadThreads) head_kernel(Args a) {
  extern __shared__ float hsm[];
  __shared__ int red[32];
  __shared__ float redf[32];
  __shared__ int cut[3];
  const int l = blockIdx.y;
  const int W = a.A > a.TW ? a.A : a.TW;
  float* saks = hsm;
  int* savs = reinterpret_cast<int*>(saks + a.A);
  float* mkeys = reinterpret_cast<float*>(savs + a.A);
  int* msrc = reinterpret_cast<int*>(mkeys + W);
  float* spk = reinterpret_cast<float*>(msrc + W);
  Adds ad{saks, savs, a.A, 0, 0, a.last_seq[l]};
  const Lane ln = lane_scalars(a, l, ad, saks, savs, red);
  const SmallKeys b{ad};
  if ((int)blockIdx.x < a.T)
    head_tile(a, l, ln, b, mkeys, msrc, cut);
  else
    head_control(a, l, ln, b, mkeys, msrc, spk, cut, red, redf);
}

// ---- launch 2: one CTA per bucket row -------------------------------------

struct Row {
  const float* bk; const int* bv; const float* pendk; const int* pendv;
  int bc_in, seg, cnt, A; bool applied;
  // the post-scatter slot s (the segment append, or the row as it was)
  __device__ float key(int s) const {
    if (!applied) return bk[s];
    if (s < bc_in) return bk[s];
    if (s < cnt) return pendk[min(max(seg + s - bc_in, 0), A - 1)];
    return f_inf();
  }
  __device__ int val(int s) const {
    if (!applied) return bv[s];
    if (s < bc_in) return bv[s];
    if (s < cnt) return pendv[min(max(seg + s - bc_in, 0), A - 1)];
    return kEmptyVal;
  }
};

__global__ void __launch_bounds__(1024) rows_kernel(Args a, int P) {
  extern __shared__ uint32_t smem[];
  uint32_t* skey = smem;
  int* sidx = reinterpret_cast<int*>(smem + P);
  __shared__ float redf[32];
  const int b = blockIdx.x, l = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int NB = a.NB, BC = a.BC;
  const size_t row = (size_t)l * NB + b;
  const int* ws = a.lane_ws + (size_t)l * kLaneWs;
  const bool applied = ws[WS_APPLIED] != 0;
  const bool move_sel = ws[WS_MOVE] != 0;
  const int bc_in = a.bcounts[row];
  Row rw{a.buckets + row * BC, a.bvals + row * BC,
         a.pendk + (size_t)l * a.A, a.pendv + (size_t)l * a.A, bc_in,
         applied ? a.seg_start[row] : 0,
         applied ? a.new_counts[row] : bc_in, a.A, applied};
  float* out_k = a.pbk + row * BC;
  int* out_v = a.pbv + row * BC;

  if (!move_sel) {
    for (int s = tid; s < BC; s += nt) { out_k[s] = rw.key(s); out_v[s] = rw.val(s); }
    return;
  }

  // stable sort of the live row: bitonic network on (u32 key, slot) pairs;
  // the pairs are distinct, so the network yields the stable order
  const int cnt = rw.cnt;
  for (int s = tid; s < P; s += nt) {
    skey[s] = s < BC ? sortable_u32(s < cnt ? rw.key(s) : f_inf())
                     : 0xffffffffu;
    sidx[s] = s;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += nt) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const uint32_t ki = skey[i], kj = skey[j];
        const int ii = sidx[i], ij = sidx[j];
        const bool gt = ki > kj || (ki == kj && ii > ij);
        if (gt == ((i & size) == 0)) {
          skey[i] = kj; skey[j] = ki; sidx[i] = ij; sidx[j] = ii;
        }
      }
      __syncthreads();
    }
  }

  // sorted position p holds slot sidx[p] (masked past the live count)
  const int ns = a.nsel[row], off = a.offs[row], keep_n = cnt - ns;
  float* selk = a.selk + (size_t)l * a.K;
  int* selv = a.selv + (size_t)l * a.K;
  for (int p = tid; p < ns; p += nt) {
    const int q = sidx[p];
    selk[off + p] = q < cnt ? rw.key(q) : f_inf();
    selv[off + p] = q < cnt ? rw.val(q) : -1;
  }
  float mn = f_inf();
  for (int s = tid; s < BC; s += nt) {
    float k = f_inf(); int v = -1;
    if (s < keep_n) {
      const int q = sidx[min(s + ns, BC - 1)];
      k = q < cnt ? rw.key(q) : f_inf();
      v = q < cnt ? rw.val(q) : -1;
      mn = key_min(mn, k);
    }
    out_k[s] = k; out_v[s] = v;
  }
  mn = block_min(mn, redf);
  if (tid == 0) a.rowmin[row] = mn;
}

// ---- launch 3: the moveHead serve and the fresh sequential part ----------

__global__ void __launch_bounds__(kMoveThreads) move_kernel(Args a) {
  __shared__ float redf[32];
  const int l = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int* ws = a.lane_ws + (size_t)l * kLaneWs;
  if (ws[WS_MOVE] == 0) return;
  const int R = a.R, SC = a.SC, K = a.K, NB = a.NB;
  const int served = ws[WS_SERVED], k = ws[WS_K], nlen = ws[WS_NLEN];
  const int move_off = ws[WS_MOVE_OFF];
  const float* selk = a.selk + (size_t)l * K;
  const int* selv = a.selv + (size_t)l * K;
  float* rmk = a.rmk + (size_t)l * R;
  int* rmv = a.rmv + (size_t)l * R;
  for (int r = tid; r < R; r += nt) {
    const int rel = r - move_off;
    if (rel >= 0 && rel < served) {
      const int j = min(rel, K - 1);
      rmk[r] = j < k ? selk[j] : f_inf();
      rmv[r] = j < k ? selv[j] : -1;
    }
  }
  float* nsk = a.nsk + (size_t)l * SC;
  int* nsv = a.nsv + (size_t)l * SC;
  for (int i = tid; i < SC; i += nt) {
    const int j = served + i;
    const bool in = i < nlen && j < K && j < k;
    nsk[i] = in ? selk[j] : f_inf();
    nsv[i] = in ? selv[j] : kEmptyVal;
  }
  float mn = f_inf();
  for (int b = tid; b < NB; b += nt)
    mn = key_min(mn, a.rowmin[(size_t)l * NB + b]);
  mn = block_min(mn, redf);
  if (tid == 0) {
    a.new_len[l] = nlen;
    a.pmin[l] = mn;
    a.pcnt[l] = ws[WS_PAR_COUNT] - ws[WS_KEXTRACT];
  }
}

}  // namespace

extern "C" {

// dims: L, A, R, SC, NB, BC, K, spill_thr, chop_patience, detach_min,
// detach_max, halve_thr, double_thr, TW (head output slots per tile CTA).
// in/out/ws: device pointers in the wrapper's order.  Returns the CUDA
// error of the launches (0 = success).
int lane_tick_launch(const long long* dims, void* const* in, void* const* out,
                     void* const* ws, void* stream) {
  Args a;
  a.seq_keys = (const float*)in[0]; a.seq_vals = (const int*)in[1];
  a.seq_len = (const int*)in[2]; a.buckets = (const float*)in[3];
  a.bvals = (const int*)in[4]; a.bcounts = (const int*)in[5];
  a.splitters = (const float*)in[6]; a.par_min = (const float*)in[7];
  a.par_count = (const int*)in[8]; a.min_value = (const float*)in[9];
  a.last_seq = (const float*)in[10]; a.detach_n = (const int*)in[11];
  a.ins_since_move = (const int*)in[12]; a.quiet_ticks = (const int*)in[13];
  a.ak = (const float*)in[14]; a.av = (const int*)in[15];
  a.am = (const int*)in[16]; a.grant = (const int*)in[17];

  a.nsk = (float*)out[0]; a.nsv = (int*)out[1]; a.new_len = (int*)out[2];
  a.pbk = (float*)out[3]; a.pbv = (int*)out[4]; a.pbc = (int*)out[5];
  a.psp = (float*)out[6]; a.pmin = (float*)out[7]; a.pcnt = (int*)out[8];
  a.rmk = (float*)out[9]; a.rmv = (int*)out[10]; a.rmc = (int*)out[11];
  a.pendk = (float*)out[12]; a.pendv = (int*)out[13];
  a.need_combine = (int*)out[14]; a.need_scatter = (int*)out[15];
  a.need_rebal = (int*)out[16]; a.need_move = (int*)out[17];
  a.r2 = (int*)out[18]; a.move_off = (int*)out[19];
  a.detach_arg = (int*)out[20]; a.need_chop = (int*)out[21];
  a.n_imm = (int*)out[22]; a.n_upc = (int*)out[23];
  a.n_rm_seq = (int*)out[24]; a.n_addseq = (int*)out[25];
  a.n_par_adds = (int*)out[26]; a.spilled = (int*)out[27];
  a.n_rm_par = (int*)out[28]; a.n_drop_rep = (int*)out[29];
  a.detach_out = (int*)out[30]; a.ins_out = (int*)out[31];
  a.quiet_out = (int*)out[32];

  a.seg_start = (int*)ws[0]; a.new_counts = (int*)ws[1];
  a.offs = (int*)ws[2]; a.nsel = (int*)ws[3]; a.rowmin = (float*)ws[4];
  a.selk = (float*)ws[5]; a.selv = (int*)ws[6]; a.lane_ws = (int*)ws[7];

  a.L = (int)dims[0]; a.A = (int)dims[1]; a.R = (int)dims[2];
  a.SC = (int)dims[3]; a.NB = (int)dims[4]; a.BC = (int)dims[5];
  a.K = (int)dims[6]; a.spill_thr = (int)dims[7];
  a.chop_patience = (int)dims[8]; a.detach_min = (int)dims[9];
  a.detach_max = (int)dims[10]; a.halve_thr = (int)dims[11];
  a.double_thr = (int)dims[12]; a.TW = (int)dims[13];
  if (a.TW < 1) return (int)cudaErrorInvalidValue;
  a.T = (int)((a.R + (long long)a.SC + a.TW - 1) / a.TW);

  cudaStream_t st = (cudaStream_t)stream;
  const size_t head_smem = head_smem_words(a.A, a.TW) * 4;
  cudaError_t err;
  if (head_smem > 40 * 1024) {   // with the static part, past 48 KB
    err = cudaFuncSetAttribute(head_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)head_smem);
    if (err != cudaSuccess) return (int)err;
  }
  head_kernel<<<dim3(a.T + 1, a.L), kHeadThreads, head_smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int P = 1;
  while (P < a.BC) P <<= 1;
  const int threads = P / 2 < 32 ? 32 : (P / 2 > 1024 ? 1024 : P / 2);
  const size_t smem = (size_t)P * 8;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rows_kernel<<<dim3(a.NB, a.L), threads, smem, st>>>(a, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  move_kernel<<<a.L, kMoveThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* lane_tick_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
