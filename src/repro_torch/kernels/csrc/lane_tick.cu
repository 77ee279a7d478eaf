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
// map).  One launch per tick, on the caller's stream.  The launch plan
// (CTA roles, their counts, threads and shared memory) is computed by the
// wrapper (kernels/lane_tick.py::launch_plan) and checked here.  Each CTA
// takes its role from an atomic ticket, in this order:
//
//   1. control   one CTA per lane: the lane's scalars from the A-long add
//                batch (counts, the consumed length s, the spill), the
//                spill window's merge, the par-bound batch [spill | large],
//                the removal stream outside the merged prefix, the scatter
//                decision, the predicates and the moveHead bookkeeping
//                (each bucket row's run offset and selected count).  It
//                depends only on the inputs and publishes in two stages on
//                its lane's flag (a release after __threadfence): 1 once
//                the scatter and the predicates are out, 2 once the
//                bookkeeping is.  Its threads follow max(A, NB): a
//                one-warp control reduces by shuffles alone; the lane's
//                scalar inputs, bucket counts, splitters and (up to
//                kSeqStage keys) its sequential part load in one pass.
//   2. head      T tile CTAs per lane: each recomputes the lane's scalars
//                (no wait) and owns output slots [t*TW, (t+1)*TW) of
//                [consumed prefix | new sequential part]: a merge path
//                (merge_path.cuh) of the sequential part with the virtual
//                small-add window, co-ranks by warp-wide searches, the
//                window merged in shared memory (ties a-first), each
//                element written straight to the removal stream or the new
//                sequential part; tiles past the merged length fill the
//                INF/EMPTY tail.
//   3. rows      RPC bucket rows a CTA: a warp a row where the row fits a
//                warp (bucket_cap <= 128); past that a warp a row where a
//                warp suffices (a segment append, a moveHead row of up to
//                kWarpSortMax live slots), else the CTA a row.  Before it
//                waits, a CTA copies its rows' live prefixes [0, count) with
//                16-byte accesses (every path writes them the same); then
//                it waits for stage 1, and for stage 2 on a moveHead lane.
//                Without moveHead it writes the rest of each post-scatter
//                row (the segment append, or the row as it was).  With
//                moveHead it sorts only the first nextpow2(count) slots of
//                a row (slots past the count hold INF with higher slot
//                indices, so the order is the full row's; none for count <=
//                1): bitonic on (u32 key, slot) in a warp's registers and
//                shuffles up to kWarpSortMax slots, in shared memory by the
//                CTA past that; the selected run prefix goes to the
//                extraction buffer at the row's offset, the survivors shift
//                left, and the row's minimum is its first survivor.
//   4. move      MT tile CTAs per lane, last: on a lane that takes moveHead
//                they wait until all of its head tiles and rows have
//                counted themselves done (an acquire on the lane's counter)
//                and write the served prefix of the removal stream and the
//                fresh sequential part from the extraction buffer, MW slots
//                a tile; tile 0 also the lane's new length, count and
//                minimum.  They overwrite what the head tiles wrote to the
//                sequential part, hence the wait.
//
// A CTA waits only on CTAs that took an earlier ticket, which are already
// running and never wait on a later one, so the launch cannot deadlock
// however many of its CTAs the card holds at once.  The tickets, flags and
// counters live in a small workspace that the wrapper keeps per (device,
// stream, lanes); it starts zeroed and the last CTA to finish zeroes it
// again, so a launch needs no extra device operation or host round trip
// (a CUDA graph can capture it).  Launches on one stream run one after
// the other, so two that share a workspace (two mesh positions on one
// card) never overlap; another stream gets its own workspace.  The kernel
// is built twice: for two CTAs an SM (no register spills), which a grid
// the card holds at once takes, and for four (64 registers), which a
// larger grid takes so that its rows CTAs are resident together.
//
// Keys compare as floats in merges, searches and predicates (-0.0 ties
// 0.0); sorts order by the u32 map (-0.0 before 0.0), and minima take -0.0
// below 0.0, as the reference does.
// No |val| < 2^24 bound, no power-of-two length and no tile divisibility:
// those belong to the TPU's one-hot MXU merge, not to this function.
//
// Bound on this card: the least a tick must move is what its ticks touch
// with the state updated in place (the batch, the removal stream, the
// scalars, 8 bytes per key stored or taken, 16 per slot moveHead
// detaches: repro_torch/roofline/traffic.py::k3_launch), under a
// microsecond at every geometry the engines run.  What bounds this launch
// instead is its latency chain (control, then rows, then move: each a
// few microseconds of dependent loads, reductions and a flag) and, since
// the engines are functional and the launch writes a new state, copying
// the bucket store (8*NB*BCAP bytes each way a lane: ~5 us at PRODUCTION).
// The design keeps the chain to one launch, sizes every role's threads to
// its work, makes row work follow the live count, copies the store's
// live prefixes while control runs, and lets rows of a lane without
// moveHead start before the moveHead bookkeeping is done.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kEmptyVal = -1;
constexpr int kLaneWs = 16;          // int32 scalars per lane in lane_ws
constexpr int kMaxThreads = 256;     // the most threads any role asks for
// Two builds of the kernel: 2 CTAs an SM (up to 128 registers, no spills)
// for a grid the card holds at once, 4 (64 registers) for a larger one,
// so that all of a wide launch's rows CTAs are resident together.
constexpr int kWarpRowMax = 128;     // bucket_cap up to this: a warp a row
constexpr int kWarpSortMax = 256;    // live slots a warp sorts in registers
constexpr int kSeqStage = 4096;      // seq_cap up to this: keys in shared
constexpr int kTraceWords = 8;       // int64 per CTA in the optional trace

// lane_ws slots
enum { WS_APPLIED = 0, WS_MOVE, WS_SERVED, WS_KEXTRACT, WS_K, WS_NLEN,
       WS_MOVE_OFF, WS_PAR_COUNT };

// the counter workspace: [ticket, finished, ctl_flag[L], lane_done[L]]
enum { CTR_TICKET = 0, CTR_FINISHED, CTR_LANES };

enum { ROLE_CONTROL = 0, ROLE_HEAD, ROLE_ROWS, ROLE_MOVE, N_ROLES };

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
  // scratch (fresh each launch, read only after this launch wrote it)
  int* seg_start; int* new_counts; int* offs;
  int* nsel; float* rowmin; float* selk; int* selv; int* lane_ws;
  // the counter workspace (zero at entry, zeroed again at exit); the
  // optional trace, [grid][kTraceWords] int64 or null
  int* ctr;
  long long* trace;
  // geometry and policy
  int L, A, R, SC, NB, BC, K, spill_thr, chop_patience, detach_min,
      detach_max, halve_thr, double_thr;
  // the plan: TW head slots per tile, T tiles; RPC rows per rows CTA, RC
  // rows CTAs; MW move slots per tile, MT tiles (all per lane); threads
  // per role; the grid
  int TW, T, RPC, RC, MW, MT, min_blocks, grid;
  int threads[N_ROLES];
};

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t sortable_u32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_sortable(uint32_t u) {
  return __uint_as_float((u >> 31) ? (u & 0x7fffffffu) : ~u);
}

// The minimum of two NaN-free keys as the reference takes it (XLA's
// minimum): -0.0 orders below 0.0.
__device__ __forceinline__ float key_min(float a, float b) {
  return (a < b || (a == b && signbit(a))) ? a : b;
}

// The card's clock in nanoseconds (the optional trace).
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---- a role's threads [0, n) of the CTA ----------------------------------

// Threads past a role's count leave at once, so a role syncs on named
// barrier 1 with its own count (a one-warp role on the warp alone).
struct Grp {
  int t, n;
  __device__ __forceinline__ void sync() const {
    if (n <= 32) __syncwarp();
    else asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
  }
};

__device__ __forceinline__ int warp_sum(int x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = key_min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ int grp_sum(const Grp& g, int x, int* red) {
  x = warp_sum(x);
  if (g.n <= 32) return x;
  const int w = g.t >> 5, nw = g.n >> 5;
  g.sync();
  if ((g.t & 31) == 0) red[w] = x;
  g.sync();
  int t = 0;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

// The group's int sum and key minimum in one exchange.
__device__ void grp_sum_min(const Grp& g, int& x, float& m, int* red,
                            float* redf) {
  x = warp_sum(x);
  m = warp_min(m);
  if (g.n <= 32) return;
  const int w = g.t >> 5, nw = g.n >> 5;
  g.sync();
  if ((g.t & 31) == 0) { red[w] = x; redf[w] = m; }
  g.sync();
  x = 0; m = f_inf();
  for (int i = 0; i < nw; ++i) { x += red[i]; m = key_min(m, redf[i]); }
}

// Exclusive prefix sum across the group; *total gets the group's sum.
__device__ int grp_excl_scan(const Grp& g, int x, int* red, int* total) {
  const int lane = g.t & 31;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (g.n <= 32) {
    *total = __shfl_sync(0xffffffffu, inc, 31);
    return inc - x;
  }
  const int w = g.t >> 5, nw = g.n >> 5;
  g.sync();
  if (lane == 31) red[w] = inc;
  g.sync();
  int before = 0, t = 0;
  for (int i = 0; i < nw; ++i) {
    if (i < w) before += red[i];
    t += red[i];
  }
  *total = t;
  return before + inc - x;
}

// Group-wide fill of p[i0, i1) with one 32-bit pattern, 16-byte stores
// where aligned.
__device__ void fill_u32(uint32_t* p, int i0, int i1, uint32_t bits, int t,
                         int nt) {
  if (i0 >= i1) return;
  const int skew = (int)((reinterpret_cast<uintptr_t>(p + i0) >> 2) & 3);
  const int a0 = min(i1, i0 + ((4 - skew) & 3));
  for (int i = i0 + t; i < a0; i += nt) p[i] = bits;
  const int nvec = (i1 - a0) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + a0);
  for (int q = t; q < nvec; q += nt) v[q] = make_uint4(bits, bits, bits, bits);
  for (int i = a0 + 4 * nvec + t; i < i1; i += nt) p[i] = bits;
}

// Group-wide copy of src[i0, i1) to dst[i0, i1), 16-byte accesses where
// both sides share an alignment.
__device__ void copy_u32(uint32_t* dst, const uint32_t* src, int i0, int i1,
                         int t, int nt) {
  if (i0 >= i1) return;
  const uintptr_t pd = reinterpret_cast<uintptr_t>(dst + i0);
  const uintptr_t ps = reinterpret_cast<uintptr_t>(src + i0);
  if ((pd ^ ps) & 15) {
    for (int i = i0 + t; i < i1; i += nt) dst[i] = src[i];
    return;
  }
  const int skew = (int)((pd >> 2) & 3);
  const int a0 = min(i1, i0 + ((4 - skew) & 3));
  for (int i = i0 + t; i < a0; i += nt) dst[i] = src[i];
  const int nvec = (i1 - a0) >> 2;
  uint4* vd = reinterpret_cast<uint4*>(dst + a0);
  const uint4* vs = reinterpret_cast<const uint4*>(src + a0);
  for (int q = t; q < nvec; q += nt) vd[q] = vs[q];
  for (int i = a0 + 4 * nvec + t; i < i1; i += nt) dst[i] = src[i];
}

// ---- flags between CTAs (thread 0 of a CTA) -------------------------------

// Publish: every write the CTA made before the caller's sync is visible
// before the counter moves.
__device__ __forceinline__ void release_add(int* p, int v) {
  __threadfence();
  atomicAdd(p, v);
}

__device__ __forceinline__ void wait_at_least(const int* p, int target) {
  while (*reinterpret_cast<const volatile int*>(p) < target) __nanosleep(32);
  __threadfence();
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

// The same count over [lo, n) when every key before lo is below x:
// galloping from lo, so a bucket boundary near the last one costs a few
// steps.
__device__ int count_less_from(const float* keys, int lo, int n, float x) {
  int hi = lo, step = 1;
  while (hi < n && keys[hi] < x) { lo = hi + 1; hi += step; step <<= 1; }
  hi = min(hi, n);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- the head: lane scalars, the combine merge ----------------------------

// The lane's scalar inputs, loaded together when a CTA starts.
struct LaneIn {
  int grant, seq_len, par_count, detach_n, ins, quiet;
  float min_value, last_seq, par_min;
};

__device__ LaneIn load_lane_in(const Args& a, int l) {
  return LaneIn{a.grant[l], a.seq_len[l], a.par_count[l], a.detach_n[l],
                a.ins_since_move[l], a.quiet_ticks[l], a.min_value[l],
                a.last_seq[l], a.par_min[l]};
}

// The lane's scalars, which every control and head CTA computes for itself.
struct Lane {
  int rmc, n_adds, n_imm, n_small, n_small_c, n_par_adds;
  bool combine;
  int s, spill_cnt, sp_start;   // consumed length, spill, kept length
};

// Loads the batch's sanitized keys and vals into shared memory (and, in
// the same pass, a short sequential part's keys into ssk, and for control
// the bucket counts and splitters into sbc / sspl), then counts.
__device__ Lane lane_scalars(const Grp& g, const Args& a, int l,
                             const LaneIn& in0, Adds& ad, float* saks,
                             int* savs, float* ssk, int* sbc, float* sspl,
                             int* red) {
  const int A = a.A, tid = g.t, nt = g.n;
  const float INF = f_inf();
  Lane ln;
  ln.rmc = min(in0.grant, a.R);
  const size_t row = (size_t)l * A;
  int c = 0;
  for (int i = tid; i < A; i += nt) {
    const bool in = a.am[row + i] != 0;
    saks[i] = in ? a.ak[row + i] : INF;
    savs[i] = in ? a.av[row + i] : kEmptyVal;
    c += in;
  }
  if (ssk)
    copy_u32(reinterpret_cast<uint32_t*>(ssk),
             reinterpret_cast<const uint32_t*>(a.seq_keys +
                                               (size_t)l * a.SC),
             0, a.SC, tid, nt);
  if (sbc) {
    for (int bk = tid; bk < a.NB; bk += nt) {
      sbc[bk] = a.bcounts[(size_t)l * a.NB + bk];
      sspl[bk] = a.splitters[(size_t)l * a.NB + bk];
    }
  }
  g.sync();                               // publishes the staged inputs
  ln.n_adds = grp_sum(g, c, red);
  const float m0 = in0.min_value;
  c = 0;
  for (int i = tid; i < A; i += nt) c += (ad.aks(i) <= m0) && (i < ln.n_adds);
  ln.n_imm = min(grp_sum(g, c, red), ln.rmc);
  ad.n_imm = ln.n_imm;
  c = 0;
  for (int i = tid; i < A; i += nt) c += ad.rem_k(i) <= ad.last;
  ln.n_small = grp_sum(g, c, red);
  ad.n_small = ln.n_small;
  int c12 = 0;                            // two counts <= A < 2^16 packed
  for (int i = tid; i < A; i += nt)
    c12 += (ad.large_k(i) < INF) + ((ad.small_k(i) < INF) << 16);
  c12 = grp_sum(g, c12, red);
  ln.n_par_adds = c12 & 0xffff;
  ln.n_small_c = c12 >> 16;               // the combine's small count
  const int seq_len = in0.seq_len;
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
// *c0 gets the co-rank of d0.  Group-wide; d1 > d0.
__device__ int merge_window(const Grp& g, const float* sk, int SC,
                            const SmallKeys& b, int A, int d0, int d1,
                            float* mkeys, int* msrc, int* cut, int* c0_out) {
  const int tid = g.t, nt = g.n;
  const merge_path::Ptr a{sk};
  for (int w = tid >> 5; w < 2; w += nt >> 5) {
    const int c = merge_path::corank_warp(a, SC, b, A, w ? d1 : d0);
    if ((tid & 31) == 0) cut[w] = c;
  }
  g.sync();
  const int c0 = cut[0], len = d1 - d0, na = cut[1] - c0, nb = len - na;
  const int j0 = d0 - c0;
  for (int p = tid; p < len; p += nt)
    mkeys[p] = p < na ? sk[c0 + p] : b(j0 + p - na);
  g.sync();
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
  g.sync();
  *c0_out = c0;
  return na;
}

// One head tile: output slots [u0, u0 + TW) of [consumed prefix (s) | new
// sequential part (SC)].
// sk: the lane's sequential keys, staged in shared memory or not.
__device__ void head_tile(const Grp& g, const Args& a, int l, int tile,
                          const Lane& ln, const SmallKeys& b, const float* sk,
                          float* mkeys, int* msrc, int* cut) {
  const int tid = g.t, nt = g.n, SC = a.SC, s = ln.s;
  const int u0 = tile * a.TW;
  const int u1 = min(u0 + a.TW, s + SC);
  if (u0 >= u1) return;
  const int* sv = a.seq_vals + (size_t)l * SC;
  float* nsk = a.nsk + (size_t)l * SC;
  int* nsv = a.nsv + (size_t)l * SC;
  if (!ln.combine) {
    copy_u32(reinterpret_cast<uint32_t*>(nsk),
             reinterpret_cast<const uint32_t*>(a.seq_keys + (size_t)l * SC),
             u0, u1, tid, nt);
    copy_u32(reinterpret_cast<uint32_t*>(nsv),
             reinterpret_cast<const uint32_t*>(sv), u0, u1, tid, nt);
    return;
  }
  const int kept = s + ln.sp_start;            // merged slots that land
  const int d1 = min(u1, kept);
  if (d1 > u0) {
    int c0;
    const int na = merge_window(g, sk, SC, b, a.A, u0, d1, mkeys, msrc, cut,
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
  fill_u32(reinterpret_cast<uint32_t*>(nsk), f0, f1, 0x7f800000u, tid, nt);
  fill_u32(reinterpret_cast<uint32_t*>(nsv), f0, f1, (uint32_t)kEmptyVal,
           tid, nt);
}

// The control CTA: the par-bound batch, the rest of the removal stream,
// the scatter decision, predicates and moveHead bookkeeping.
// sk: the sequential keys (staged or not); sbc / sspl: the staged bucket
// counts and splitters; snc: room for the new counts.
__device__ void head_control(const Grp& g, const Args& a, int l,
                             const LaneIn& in0, const Lane& ln,
                             const SmallKeys& b, const float* sk,
                             const int* bcin, const float* spl, int* snc,
                             float* mkeys, int* msrc, float* spk, int* cut,
                             int* red, float* redf, long long* tr,
                             int* flag) {
  const int tid = g.t, nt = g.n;
  const int A = a.A, R = a.R, SC = a.SC, NB = a.NB, BC = a.BC;
  const int M = SC + A;
  const float INF = f_inf();
  const Adds& ad = b.ad;
  const int* sv = a.seq_vals + (size_t)l * SC;
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
      const int na = merge_window(g, sk, SC, b, A, g0, g0 + nv, mkeys, msrc,
                                  cut, &c0);
      const int j0 = g0 - c0;
      for (int p = tid; p < nv; p += nt) {
        const int q = msrc[p];
        spk[p] = mkeys[q];
        pendv[p] = q < na ? sv[c0 + q] : ad.small_v(j0 + q - na);
      }
    }
    g.sync();
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
  g.sync();   // spk is read by every thread below
  float kmin = INF;
  int n_pend = 0;
  for (int i = tid; i < A; i += nt) {
    const float k = spk[i];
    pendk[i] = k;
    if (k < INF) { ++n_pend; kmin = key_min(kmin, k); }
  }
  grp_sum_min(g, n_pend, kmin, red, redf);
  const int new_len = combine ? sp_start : in0.seq_len;
  const int move_off = n_imm + s;
  const int n_rm_seq = s - n_upc;
  const int n_addseq = ln.n_small_c - n_upc;
  bool scatter = ln.n_par_adds > 0 || (combine && spill_cnt > 0);

  if (tr && tid == 0) tr[5] = global_ns();
  // ---- scatter: SL::addPar() segment append (the rows CTAs write the
  // rows); an overflow discards it and asks for the rebalance ----
  float par_min = in0.par_min;
  int par_count = in0.par_count;
  bool applied = false, rebal = false;
  if (scatter) {
    // each thread a run of consecutive buckets: a bucket's segment starts
    // where the last one's ends
    int c = 0;
    const int per = (NB + nt - 1) / nt;
    const int b0 = min(tid * per, NB), b1 = min(b0 + per, NB);
    int start = b0 == 0 ? 0 : count_less(spk, A, spl[b0]);
    for (int bk = b0; bk < b1; ++bk) {
      const float x = bk + 1 < NB ? spl[bk + 1] : INF;
      const int end = bk == 0 || x >= spl[bk]
                          ? count_less_from(spk, start, A, x)
                          : count_less(spk, A, x);
      const int nc = bcin[bk] + end - start;
      seg_start[bk] = start;
      new_counts[bk] = nc;
      snc[bk] = nc;
      c += nc > BC;
      start = end;
    }
    const bool overflow = grp_sum(g, c, red) > 0;
    applied = !overflow;
    rebal = overflow;
    if (applied) {
      par_min = key_min(par_min, kmin);
      par_count += n_pend;
    }
  }

  if (tr && tid == 0) tr[6] = global_ns();
  // ---- predicates ----
  const int r2 = rmc - move_off;
  const int count_eff = par_count + (rebal ? n_pend : 0);
  const bool move = r2 > 0 && count_eff > 0;
  const int ins = in0.ins + n_addseq;
  const int d = in0.detach_n;
  const int halved = max(a.detach_min, d / 2);
  const int doubled = min(a.detach_max, d * 2);
  const int nd = ins > a.halve_thr ? halved
               : (ins < a.double_thr ? doubled : d);
  int quiet = rmc > 0 ? 0 : in0.quiet + 1;
  const bool chop = quiet >= a.chop_patience && new_len > 0;
  if (chop) quiet = 0;

  // stage 1: the rows of a lane without moveHead may go (the scatter's
  // segments and counts, pend_*, applied and move_sel are out)
  const bool move_sel = move && !rebal;
  if (tid == 0) { ws[WS_APPLIED] = applied; ws[WS_MOVE] = move_sel; }
  g.sync();
  if (tid == 0) release_add(flag, 1);

  // ---- moveHead bookkeeping (the rows and the move tiles come next):
  // each thread owns a run of consecutive buckets, one scan over them ----
  int served = 0, k_extract = 0, k = 0;
  int* pbc = a.pbc + (size_t)l * NB;
  if (move_sel) {
    served = min(r2, par_count);
    k_extract = min(max(d, r2), par_count);
    k_extract = min(k_extract, served + a.spill_thr);
    const int per = (NB + nt - 1) / nt;
    const int b0 = min(tid * per, NB), b1 = min(b0 + per, NB);
    int local = 0;
    for (int bk = b0; bk < b1; ++bk)
      local += applied ? snc[bk] : bcin[bk];
    int total;
    int off = grp_excl_scan(g, local, red, &total);
    k = min(min(k_extract, total), a.K);
    for (int bk = b0; bk < b1; ++bk) {
      const int cnt = applied ? snc[bk] : bcin[bk];
      const int ns = min(max(k - off, 0), cnt);
      offs[bk] = off;
      nsel[bk] = ns;
      pbc[bk] = cnt - ns;
      off += cnt;
    }
  } else {
    for (int bk = tid; bk < NB; bk += nt)
      pbc[bk] = applied ? snc[bk] : bcin[bk];
  }
  if (tid == 0) {
    ws[WS_SERVED] = served;
    ws[WS_KEXTRACT] = k_extract;
    ws[WS_K] = k;
    ws[WS_NLEN] = k_extract - served;
    ws[WS_MOVE_OFF] = move_off;
    ws[WS_PAR_COUNT] = par_count;
    a.new_len[l] = new_len;
    a.pmin[l] = par_min;          // the move tiles replace both on moveHead
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
  // stage 2: the moveHead rows may go (run offsets and selected counts
  // are out, and what the move tiles overwrite is written)
  g.sync();
  if (tid == 0) release_add(flag, 1);
  for (int bk = tid; bk < NB; bk += nt) a.psp[(size_t)l * NB + bk] = spl[bk];
}

// Dynamic shared memory, in 32-bit words: control, the batch's sanitized
// keys and vals [2A], the spill window's keys and sources [2A], the
// par-bound batch [A], the bucket counts, splitters and new counts [3NB];
// a head tile, the batch [2A] and its window [2HW], HW = min(TW, R + SC);
// both, a sequential part of up to kSeqStage keys [SC]; a rows CTA past a
// warp's rows, (u32 key, slot) pairs [2 nextpow2(BC)].
__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__host__ __device__ inline size_t role_smem_words(int role, int A, int HW,
                                                  int BC, int NB, int SC) {
  const size_t seq = SC <= kSeqStage ? SC : 0;
  switch (role) {
    case ROLE_CONTROL: return (size_t)5 * A + (size_t)3 * NB + seq;
    case ROLE_HEAD: return (size_t)2 * A + (size_t)2 * HW + seq;
    case ROLE_ROWS:
      return BC > kWarpRowMax ? (size_t)2 * next_pow2(BC) : 0;
    default: return 0;
  }
}

// ---- the rows: one bucket row's post-scatter form and moveHead ----------

struct Row {
  const float* bk; const int* bv; const float* pendk; const int* pendv;
  int bc_in, seg, cnt, A; bool applied;
  // the post-scatter slot s < cnt (the segment append, or the row as it
  // was); pend_* were written by this launch's control CTA
  __device__ float key(int s) const {
    if (!applied || s < bc_in) return bk[s];
    return __ldcg(pendk + min(max(seg + s - bc_in, 0), A - 1));
  }
  __device__ int val(int s) const {
    if (!applied || s < bc_in) return bv[s];
    return __ldcg(pendv + min(max(seg + s - bc_in, 0), A - 1));
  }
};

// What every path writes the same: the row's live prefix [0, bc_in).
__device__ void row_prefix(const Args& a, size_t row, int t, int nt) {
  const int BC = a.BC, bc_in = min(max(a.bcounts[row], 0), BC);
  copy_u32(reinterpret_cast<uint32_t*>(a.pbk + row * BC),
           reinterpret_cast<const uint32_t*>(a.buckets + row * BC), 0, bc_in,
           t, nt);
  copy_u32(reinterpret_cast<uint32_t*>(a.pbv + row * BC),
           reinterpret_cast<const uint32_t*>(a.bvals + row * BC), 0, bc_in,
           t, nt);
}

__device__ Row make_row(const Args& a, int l, size_t row, bool applied) {
  const int bc_in = a.bcounts[row];
  return Row{a.buckets + row * a.BC, a.bvals + row * a.BC,
             a.pendk + (size_t)l * a.A, a.pendv + (size_t)l * a.A, bc_in,
             applied ? __ldcg(a.seg_start + row) : 0,
             applied ? __ldcg(a.new_counts + row) : bc_in, a.A, applied};
}

// The rest of a row without moveHead: the row as it was past its count,
// or the appended segment and the INF/EMPTY tail.
__device__ void row_rest(const Args& a, const Row& rw, size_t row, int t,
                         int nt) {
  const int BC = a.BC;
  uint32_t* ok = reinterpret_cast<uint32_t*>(a.pbk + row * BC);
  uint32_t* ov = reinterpret_cast<uint32_t*>(a.pbv + row * BC);
  const int lo = min(max(rw.bc_in, 0), BC);
  if (!rw.applied) {
    copy_u32(ok, reinterpret_cast<const uint32_t*>(rw.bk), lo, BC, t, nt);
    copy_u32(ov, reinterpret_cast<const uint32_t*>(rw.bv), lo, BC, t, nt);
    return;
  }
  const int cnt = min(rw.cnt, BC);
  for (int s = lo + t; s < cnt; s += nt) {
    ok[s] = __float_as_uint(rw.key(s));
    ov[s] = (uint32_t)rw.val(s);
  }
  fill_u32(ok, cnt, BC, 0x7f800000u, t, nt);
  fill_u32(ov, cnt, BC, (uint32_t)kEmptyVal, t, nt);
}

// Sorted position p of a moveHead row holds (key, val): the first ns go to
// the extraction buffer at the row's offset, the rest shift left by ns;
// the row's minimum is its first survivor.
struct RowOut {
  float* out_k; int* out_v; float* selk; int* selv; float* rowmin;
  int ns, off, cnt;
  __device__ void put(int p, float k, int v) const {
    if (p < ns) { selk[off + p] = k; selv[off + p] = v; return; }
    out_k[p - ns] = k; out_v[p - ns] = v;
    if (p == ns) *rowmin = k;
  }
};

__device__ RowOut make_row_out(const Args& a, int l, size_t row, int cnt) {
  return RowOut{a.pbk + row * a.BC, a.pbv + row * a.BC,
                a.selk + (size_t)l * a.K, a.selv + (size_t)l * a.K,
                a.rowmin + row, __ldcg(a.nsel + row), __ldcg(a.offs + row),
                cnt};
}

// The tail of a moveHead row past its survivors, and its minimum when it
// keeps none.
__device__ void row_out_tail(const Args& a, const RowOut& o, int t, int nt) {
  const int keep_n = o.cnt - o.ns;
  fill_u32(reinterpret_cast<uint32_t*>(o.out_k), keep_n, a.BC, 0x7f800000u,
           t, nt);
  fill_u32(reinterpret_cast<uint32_t*>(o.out_v), keep_n, a.BC,
           (uint32_t)kEmptyVal, t, nt);
  if (t == 0 && keep_n <= 0) *o.rowmin = f_inf();
}

// One compare-exchange stage inside a lane: elements j and j ^ JS.
template <int E, int JS>
__device__ __forceinline__ void cx_in_lane(uint32_t (&k)[E], int (&x)[E],
                                           int (&v)[E], int size, int lane) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int jp = j ^ JS;
    if (jp > j && jp < E) {
      const bool asc = ((j * 32 + lane) & size) == 0;
      const bool gt = k[j] > k[jp] || (k[j] == k[jp] && x[j] > x[jp]);
      if (gt == asc) {
        const uint32_t tk = k[j]; k[j] = k[jp]; k[jp] = tk;
        const int tx = x[j]; x[j] = x[jp]; x[jp] = tx;
        const int tv = v[j]; v[j] = v[jp]; v[jp] = tv;
      }
    }
  }
}

// A warp's stable sort of a row's first cnt slots (P = nextpow2(cnt) <=
// 32 E): element e = 32 j + lane holds (u32 key, slot, val); bitonic on
// (key, slot), which are distinct, so the order is the stable one.
template <int E>
__device__ void warp_sort_row(const Row& rw, const RowOut& o, int P) {
  const int lane = threadIdx.x & 31, cnt = rw.cnt;
  uint32_t k[E]; int x[E], v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = j * 32 + lane;
    const bool in = e < cnt;
    k[j] = in ? sortable_u32(rw.key(e)) : 0xffffffffu;
    x[j] = e;
    v[j] = in ? rw.val(e) : kEmptyVal;
  }
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 128) {
        cx_in_lane<E, 4>(k, x, v, size, lane);
      } else if (stride == 64) {
        cx_in_lane<E, 2>(k, x, v, size, lane);
      } else if (stride == 32) {
        cx_in_lane<E, 1>(k, x, v, size, lane);
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const uint32_t pk = __shfl_xor_sync(0xffffffffu, k[j], stride);
          const int px = __shfl_xor_sync(0xffffffffu, x[j], stride);
          const int pv = __shfl_xor_sync(0xffffffffu, v[j], stride);
          const bool asc = ((j * 32 + lane) & size) == 0;
          const bool gt = k[j] > pk || (k[j] == pk && x[j] > px);
          if ((lower == asc) == gt) { k[j] = pk; x[j] = px; v[j] = pv; }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = j * 32 + lane;
    if (e < cnt) o.put(e, from_sortable(k[j]), v[j]);
  }
}

// A warp sorts a moveHead row whose live count fits its registers
// (kWarpSortMax).
__device__ void warp_move_row(const Row& rw, const RowOut& o) {
  const int P = next_pow2(max(rw.cnt, 1));
  if (P <= 32) warp_sort_row<1>(rw, o, P);
  else if (P <= 64) warp_sort_row<2>(rw, o, P);
  else if (P <= 128) warp_sort_row<4>(rw, o, P);
  else warp_sort_row<8>(rw, o, P);
}

// A CTA sorts a moveHead row past a warp's reach: bitonic over the first
// P = nextpow2(cnt) slots' (u32 key, slot) pairs in shared memory.
__device__ void cta_move_row(const Grp& g, const Row& rw, const RowOut& o,
                             uint32_t* skey, int* sidx) {
  const int tid = g.t, nt = g.n, cnt = rw.cnt;
  const int P = next_pow2(max(cnt, 1));
  g.sync();   // the last row's readers are done with skey / sidx
  for (int s = tid; s < P; s += nt) {
    skey[s] = s < cnt ? sortable_u32(rw.key(s)) : 0xffffffffu;
    sidx[s] = s;
  }
  g.sync();
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
      g.sync();
    }
  }
  for (int p = tid; p < cnt; p += nt)
    o.put(p, from_sortable(skey[p]), rw.val(sidx[p]));
}

// ---- the kernel ------------------------------------------------------------


// The prefix every path writes the same, for rows [b0, b1) of lane l: a
// warp per row, or the group per row past a warp's rows.
__device__ void rows_prefix(const Grp& g, const Args& a, int l, int b0,
                            int b1) {
  const bool warp_rows = a.BC <= kWarpRowMax;
  const int step = warp_rows ? g.n >> 5 : 1;
  const int rt = warp_rows ? g.t & 31 : g.t, rn = warp_rows ? 32 : g.n;
  for (int b = b0 + (warp_rows ? g.t >> 5 : 0); b < b1; b += step)
    row_prefix(a, (size_t)l * a.NB + b, rt, rn);
}

// The rest of rows [b0, b1) of lane l once control has published.
__device__ void rows_rest(const Grp& g, const Args& a, int l, int b0, int b1,
                          float* dsm) {
  const bool warp_rows = a.BC <= kWarpRowMax;
  const int* ws = a.lane_ws + (size_t)l * kLaneWs;
  const bool applied = __ldcg(ws + WS_APPLIED) != 0;
  const bool move_sel = __ldcg(ws + WS_MOVE) != 0;
  if (!warp_rows) {
    // past a warp's rows, warps first take the rows that need no CTA, a
    // row each: a moveHead row of at most kWarpSortMax live slots, or
    // the segment append of a row without moveHead (gathers and stores)
    for (int b = b0 + (g.t >> 5); b < b1; b += g.n >> 5) {
      const size_t row = (size_t)l * a.NB + b;
      const Row rw = make_row(a, l, row, applied);
      if (move_sel && rw.cnt <= kWarpSortMax) {
        const RowOut o = make_row_out(a, l, row, rw.cnt);
        warp_move_row(rw, o);
        row_out_tail(a, o, g.t & 31, 32);
      } else if (!move_sel && applied) {
        row_rest(a, rw, row, g.t & 31, 32);
      }
    }
    if (!move_sel && applied) return;
    // then the CTA, a row at a time: a longer moveHead row's sort, or a
    // row copied as it was (loads and stores)
    for (int b = b0; b < b1; ++b) {
      const size_t row = (size_t)l * a.NB + b;
      const Row rw = make_row(a, l, row, applied);
      if (!move_sel) {
        row_rest(a, rw, row, g.t, g.n);
      } else if (rw.cnt > kWarpSortMax) {
        const RowOut o = make_row_out(a, l, row, rw.cnt);
        uint32_t* skey = reinterpret_cast<uint32_t*>(dsm);
        cta_move_row(g, rw, o, skey,
                     reinterpret_cast<int*>(skey + next_pow2(a.BC)));
        row_out_tail(a, o, g.t, g.n);
      }
    }
    return;
  }
  for (int b = b0 + (g.t >> 5); b < b1; b += g.n >> 5) {
    const size_t row = (size_t)l * a.NB + b;
    const Row rw = make_row(a, l, row, applied);
    if (!move_sel) {
      row_rest(a, rw, row, g.t & 31, 32);
      continue;
    }
    const RowOut o = make_row_out(a, l, row, rw.cnt);
    warp_move_row(rw, o);
    row_out_tail(a, o, g.t & 31, 32);
  }
}

// Move slots [u0, u1) of lane l, which took moveHead: [0, SC) the fresh
// sequential part, [SC, SC + R) the removal stream, of which the served
// prefix at move_off changes; with ``first``, the lane's new length,
// count and minimum.
__device__ void move_tile(const Grp& g, const Args& a, int l, int u0, int u1,
                          bool first, int* red, float* redf) {
  const int* ws = a.lane_ws + (size_t)l * kLaneWs;
  const int R = a.R, SC = a.SC, K = a.K, NB = a.NB;
  const int served = __ldcg(ws + WS_SERVED), k = __ldcg(ws + WS_K);
  const int nlen = __ldcg(ws + WS_NLEN);
  const int move_off = __ldcg(ws + WS_MOVE_OFF);
  const float* selk = a.selk + (size_t)l * K;
  const int* selv = a.selv + (size_t)l * K;
  float* nsk = a.nsk + (size_t)l * SC;
  int* nsv = a.nsv + (size_t)l * SC;
  float* rmk = a.rmk + (size_t)l * R;
  int* rmv = a.rmv + (size_t)l * R;
  for (int u = u0 + g.t; u < u1; u += g.n) {
    if (u < SC) {
      const int j = served + u;
      const bool in = u < nlen && j < K && j < k;
      nsk[u] = in ? __ldcg(selk + j) : f_inf();
      nsv[u] = in ? __ldcg(selv + j) : kEmptyVal;
    } else {
      const int r = u - SC, rel = r - move_off;
      if (rel >= 0 && rel < served) {
        const int j = min(rel, K - 1);
        rmk[r] = j < k ? __ldcg(selk + j) : f_inf();
        rmv[r] = j < k ? __ldcg(selv + j) : kEmptyVal;
      }
    }
  }
  if (first) {
    float mn = f_inf();
    for (int bk = g.t; bk < NB; bk += g.n)
      mn = key_min(mn, __ldcg(a.rowmin + (size_t)l * NB + bk));
    int unused = 0;
    grp_sum_min(g, unused, mn, red, redf);
    if (g.t == 0) {
      a.new_len[l] = nlen;
      a.pmin[l] = mn;
      a.pcnt[l] = __ldcg(ws + WS_PAR_COUNT) - __ldcg(ws + WS_KEXTRACT);
    }
  }
}

template <int MinBlocks>
__global__ void __launch_bounds__(kMaxThreads, MinBlocks)
    lane_tick_kernel(Args a) {
  extern __shared__ __align__(16) float dsm[];
  __shared__ int red[32];
  __shared__ float redf[32];
  __shared__ int cut[3];
  __shared__ int s_ticket, s_move;
  int* const flag = a.ctr + CTR_LANES;        // control published, per lane
  int* const done = flag + a.L;               // head tiles + rows CTAs done

  if (threadIdx.x == 0) s_ticket = atomicAdd(a.ctr + CTR_TICKET, 1);
  __syncthreads();
  int t = s_ticket, role, l, idx;
  if (t < a.L) { role = ROLE_CONTROL; l = t; idx = 0; }
  else if ((t -= a.L) < a.L * a.T) { role = ROLE_HEAD; l = t / a.T; idx = t % a.T; }
  else if ((t -= a.L * a.T) < a.L * a.RC) { role = ROLE_ROWS; l = t / a.RC; idx = t % a.RC; }
  else { t -= a.L * a.RC; role = ROLE_MOVE; l = t / a.MT; idx = t % a.MT; }
  const Grp g{(int)threadIdx.x,
              role == ROLE_CONTROL ? a.threads[ROLE_CONTROL]
              : role == ROLE_HEAD  ? a.threads[ROLE_HEAD]
              : role == ROLE_ROWS  ? a.threads[ROLE_ROWS]
                                   : a.threads[ROLE_MOVE]};
  // trace row of this ticket: role << 32 | lane, start, ready (its wait
  // over), end, then control's milestones (scalars counted, combine
  // merged, scatter decided), in globaltimer nanoseconds
  long long* tr = a.trace ? a.trace + kTraceWords * (size_t)s_ticket
                          : nullptr;
  if (tr && threadIdx.x == 0) {
    tr[0] = ((long long)role << 32) | l;
    tr[1] = tr[2] = global_ns();
  }

  if (g.t < g.n) {
    if (role == ROLE_CONTROL || role == ROLE_HEAD) {
      // shared: the batch [2A], a merge window [2W], then control's par
      // batch [A] and bucket arrays [3NB], then the staged keys [SC]
      const bool ctl = role == ROLE_CONTROL;
      const int W = ctl ? a.A : min(a.TW, a.R + a.SC);
      float* saks = dsm;
      int* savs = reinterpret_cast<int*>(saks + a.A);
      float* mkeys = reinterpret_cast<float*>(savs + a.A);
      int* msrc = reinterpret_cast<int*>(mkeys + W);
      float* spk = reinterpret_cast<float*>(msrc + W);
      int* sbc = reinterpret_cast<int*>(spk + (ctl ? a.A : 0));
      float* sspl = reinterpret_cast<float*>(sbc + (ctl ? a.NB : 0));
      int* snc = reinterpret_cast<int*>(sspl + (ctl ? a.NB : 0));
      float* ssk = reinterpret_cast<float*>(snc + (ctl ? a.NB : 0));
      const bool staged = a.SC <= kSeqStage;
      const float* sk = staged ? ssk : a.seq_keys + (size_t)l * a.SC;
      const LaneIn in0 = load_lane_in(a, l);
      Adds ad{saks, savs, a.A, 0, 0, in0.last_seq};
      const Lane ln = lane_scalars(g, a, l, in0, ad, saks, savs,
                                   staged ? ssk : nullptr,
                                   ctl ? sbc : nullptr, sspl, red);
      const SmallKeys b{ad};
      if (tr && g.t == 0) tr[4] = global_ns();
      if (!ctl) {
        head_tile(g, a, l, idx, ln, b, sk, mkeys, msrc, cut);
        g.sync();
        if (g.t == 0) release_add(done + l, 1);
      } else {
        head_control(g, a, l, in0, ln, b, sk, sbc, sspl, snc, mkeys, msrc,
                     spk, cut, red, redf, tr, flag + l);
      }
    } else if (role == ROLE_ROWS) {
      const int b0 = idx * a.RPC, b1 = min(b0 + a.RPC, a.NB);
      rows_prefix(g, a, l, b0, b1);
      if (g.t == 0) {
        wait_at_least(flag + l, 1);
        if (__ldcg(a.lane_ws + (size_t)l * kLaneWs + WS_MOVE))
          wait_at_least(flag + l, 2);
        if (tr) tr[2] = global_ns();
      }
      g.sync();
      rows_rest(g, a, l, b0, b1, dsm);
      g.sync();
      if (g.t == 0) release_add(done + l, 1);
    } else {
      if (g.t == 0) {
        wait_at_least(flag + l, 1);
        s_move = __ldcg(a.lane_ws + (size_t)l * kLaneWs + WS_MOVE);
        if (s_move) wait_at_least(done + l, a.T + a.RC);
        if (tr) tr[2] = global_ns();
      }
      g.sync();
      if (s_move)
        move_tile(g, a, l, idx * a.MW, min((idx + 1) * a.MW, a.SC + a.R),
                  idx == 0, red, redf);
    }
  }
  // the last CTA to finish zeroes the counter workspace for the next launch
  if (threadIdx.x == 0) {
    if (tr) tr[3] = global_ns();
    __threadfence();
    if (atomicAdd(a.ctr + CTR_FINISHED, 1) == a.grid - 1) {
      a.ctr[CTR_TICKET] = 0;
      for (int i = 0; i < 2 * a.L; ++i) flag[i] = 0;
      a.ctr[CTR_FINISHED] = 0;
    }
  }
}

}  // namespace

extern "C" {

// dims: L, A, R, SC, NB, BC, K, spill_thr, chop_patience, detach_min,
// detach_max, halve_thr, double_thr, then the launch plan: TW, T, RPC, RC,
// MW, MT, threads of the four roles (control, head, rows, move),
// shared bytes of the four roles, the block's threads, CTAs an SM (2 or
// 4: which build of the kernel).  in/out/ws: device
// pointers in the wrapper's order (ws ends with the counter workspace, 2 +
// 2L int32, zero, and the trace, [grid][8] int64, or null).  Returns the
// CUDA error of the launch (0 = success); cudaErrorInvalidValue for a plan
// that leaves a slot, a row or a role's shared memory short.
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
  a.ctr = (int*)ws[8];
  a.trace = (long long*)ws[9];

  a.L = (int)dims[0]; a.A = (int)dims[1]; a.R = (int)dims[2];
  a.SC = (int)dims[3]; a.NB = (int)dims[4]; a.BC = (int)dims[5];
  a.K = (int)dims[6]; a.spill_thr = (int)dims[7];
  a.chop_patience = (int)dims[8]; a.detach_min = (int)dims[9];
  a.detach_max = (int)dims[10]; a.halve_thr = (int)dims[11];
  a.double_thr = (int)dims[12];
  a.TW = (int)dims[13]; a.T = (int)dims[14]; a.RPC = (int)dims[15];
  a.RC = (int)dims[16]; a.MW = (int)dims[17]; a.MT = (int)dims[18];
  size_t smem = 0;
  for (int r = 0; r < N_ROLES; ++r) {
    a.threads[r] = (int)dims[19 + r];
    const size_t need =
        role_smem_words(r, a.A, a.TW < a.R + a.SC ? a.TW : a.R + a.SC,
                        a.BC, a.NB, a.SC) * 4;
    if ((size_t)dims[23 + r] < need) return (int)cudaErrorInvalidValue;
    if ((size_t)dims[23 + r] > smem) smem = (size_t)dims[23 + r];
  }
  const int block = (int)dims[27];
  a.min_blocks = (int)dims[28];

  // the plan must cover every slot and row once and fit its block
  const long long head_n = (long long)a.R + a.SC;
  bool ok = a.L > 0 && a.TW > 0 && a.RPC > 0 && a.MW > 0 &&
            block <= kMaxThreads && (a.min_blocks == 2 || a.min_blocks == 4) &&
            (long long)a.T * a.TW >= head_n &&
            (long long)a.RC * a.RPC >= a.NB &&
            (long long)a.MT * a.MW >= head_n;
  for (int r = 0; r < N_ROLES; ++r)
    ok = ok && a.threads[r] >= 32 && a.threads[r] % 32 == 0 &&
         a.threads[r] <= block;
  if (!ok) return (int)cudaErrorInvalidValue;
  a.grid = a.L * (1 + a.T + a.RC + a.MT);

  cudaStream_t st = (cudaStream_t)stream;
  void (*kern)(Args) =
      a.min_blocks == 4 ? lane_tick_kernel<4> : lane_tick_kernel<2>;
  cudaError_t err;
  if (smem > 40 * 1024) {   // with the static part, past 48 KB
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<a.grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
}

const char* lane_tick_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
