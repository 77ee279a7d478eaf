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
//   1. head_kernel    grid (L), one CTA per lane: head, combine (merge path
//                     by rank into a global workspace), scatter decision,
//                     predicates, and the moveHead bookkeeping.
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
// 0.0); sorts order by the u32 map (-0.0 before 0.0), as the reference does.
// No |val| < 2^24 bound, no power-of-two length and no tile divisibility:
// those belong to the TPU's one-hot MXU merge, not to this function.
//
// Bound on this card: the work is data movement.  Per tick a lane reads its
// state and writes it back (sequential part 8*seq_cap bytes, bucket store
// 8*NB*BCAP bytes each way, plus the batch): about 0.5 MB at the w4096
// geometry and about 18 MB at PRODUCTION, i.e. about 5.5 us of HBM traffic
// at 3.35 TB/s; one launch's latency (a few us) is below that.  What the
// design does about it: nothing yet.  This kernel is right first; head and
// move run in one CTA per lane, so one SM carries the sequential part.
// Making it fast (state in shared memory, clusters with distributed shared
// memory for seq_cap 16384+, in-place updates) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEmptyVal = -1;
constexpr int kLaneWs = 16;          // int32 scalars per lane in lane_ws
constexpr int kHeadThreads = 1024;

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
  float* mk; int* mv; int* mf; int* seg_start; int* new_counts; int* offs;
  int* nsel; float* rowmin; float* selk; int* selv; int* lane_ws;
  // geometry and policy
  int L, A, R, SC, NB, BC, K, spill_thr, chop_patience, detach_min,
      detach_max, halve_thr, double_thr;
};

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t sortable_u32(float x) {
  uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
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
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = (blockDim.x + 31) >> 5;
  __syncthreads();
  if (lane == 0) red[w] = x;
  __syncthreads();
  float t = f_inf();
  for (int i = 0; i < nw; ++i) t = fminf(t, red[i]);
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

// ---- the lane's add batch, as closed-form index arithmetic ---------------

struct Adds {
  const float* ak; const int* av; const int* am;
  int A, n_imm, n_small; float last;
  __device__ float aks(int i) const { return am[i] ? ak[i] : f_inf(); }
  __device__ int avs(int i) const { return am[i] ? av[i] : kEmptyVal; }
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

// #{i < n : keys[i] < x} over a nondecreasing row
__device__ int count_less(const float* keys, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i < n : keys[i] <= x} over a nondecreasing row
__device__ int count_leq(const float* keys, int n, float x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- launch 1: head, combine, scatter decision, predicates ---------------

__global__ void __launch_bounds__(kHeadThreads) head_kernel(Args a) {
  __shared__ int red[32];
  __shared__ float redf[32];
  const int l = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int A = a.A, R = a.R, SC = a.SC, NB = a.NB, BC = a.BC;
  const int M = SC + A;
  const float INF = f_inf();

  const float* sk = a.seq_keys + (size_t)l * SC;
  const int* sv = a.seq_vals + (size_t)l * SC;
  const int* bcin = a.bcounts + (size_t)l * NB;
  const float* spl = a.splitters + (size_t)l * NB;
  float* mk = a.mk + (size_t)l * M;
  int* mv = a.mv + (size_t)l * M;
  int* mf = a.mf + (size_t)l * M;
  float* nsk = a.nsk + (size_t)l * SC;
  int* nsv = a.nsv + (size_t)l * SC;
  float* rmk = a.rmk + (size_t)l * R;
  int* rmv = a.rmv + (size_t)l * R;
  float* pendk = a.pendk + (size_t)l * A;
  int* pendv = a.pendv + (size_t)l * A;
  int* seg_start = a.seg_start + (size_t)l * NB;
  int* new_counts = a.new_counts + (size_t)l * NB;
  int* offs = a.offs + (size_t)l * NB;
  int* nsel = a.nsel + (size_t)l * NB;
  int* ws = a.lane_ws + (size_t)l * kLaneWs;

  const int seq_len = a.seq_len[l];
  Adds ad{a.ak + (size_t)l * A, a.av + (size_t)l * A, a.am + (size_t)l * A,
          A, 0, 0, a.last_seq[l]};

  // ---- head: sanitize, immediate elimination, small/large split ----
  const int rmc = min(a.grant[l], R);
  int c = 0;
  for (int i = tid; i < A; i += nt) c += ad.am[i] != 0;
  const int n_adds = block_sum(c, red);
  const float m0 = a.min_value[l];
  c = 0;
  for (int i = tid; i < A; i += nt) c += (ad.aks(i) <= m0) && (i < n_adds);
  const int n_elig = block_sum(c, red);
  const int n_imm = min(n_elig, rmc);
  ad.n_imm = n_imm;
  c = 0;
  for (int i = tid; i < A; i += nt) c += ad.rem_k(i) <= ad.last;
  const int n_small = block_sum(c, red);
  ad.n_small = n_small;
  int c1 = 0, c2 = 0;
  for (int i = tid; i < A; i += nt) {
    c1 += ad.large_k(i) < INF;
    c2 += ad.small_k(i) < INF;
  }
  const int n_par_adds = block_sum(c1, red);
  const int n_small_c = block_sum(c2, red);   // the combine's small count

  const bool combine = seq_len > 0 || n_small > 0;
  bool scatter = n_par_adds > 0;

  // ---- combine: merge path by rank, consume, spill ----
  int s = 0, move_off = n_imm, new_len = seq_len;
  int n_upc = 0, n_rm_seq = 0, n_addseq = 0, spill_cnt = 0;
  if (combine) {
    // a[i] -> i + #{b < a[i]},  b[j] -> j + #{a <= b[j]}  (ties a-first)
    for (int i = tid; i < SC; i += nt) {
      const float x = sk[i];
      int lo = 0, hi = A;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (ad.small_k(mid) < x) lo = mid + 1; else hi = mid;
      }
      mk[i + lo] = x; mv[i + lo] = sv[i]; mf[i + lo] = 0;
    }
    for (int j = tid; j < A; j += nt) {
      const float y = ad.small_k(j);
      const int pos = j + count_leq(sk, SC, y);
      mk[pos] = y; mv[pos] = ad.small_v(j); mf[pos] = y < INF;
    }
    __syncthreads();
    const int r1 = rmc - n_imm;
    const int avail = seq_len + n_small_c;
    s = min(r1, avail);
    c = 0;
    for (int j = tid; j < s; j += nt) c += mf[j] != 0;
    n_upc = block_sum(c, red);
    n_rm_seq = s - n_upc;
    n_addseq = n_small_c - n_upc;
    const int nl1 = avail - s;
    spill_cnt = max(0, nl1 - a.spill_thr);
    const int sp_start = nl1 - spill_cnt;
    for (int i = tid; i < SC; i += nt) {
      const int q = s + i;
      const bool in = i < sp_start && q < M;
      nsk[i] = in ? mk[q] : INF;
      nsv[i] = in ? mv[q] : kEmptyVal;
    }
    // par-bound batch: [spill | large]
    for (int i = tid; i < A; i += nt) {
      float k; int v;
      if (i < spill_cnt) {
        const int q = sp_start + i, g = s + q;
        const bool in = q < SC && g < M;
        k = in ? mk[g] : INF;
        v = in ? mv[g] : kEmptyVal;
      } else {
        k = ad.large_k(i - spill_cnt);
        v = ad.large_v(i - spill_cnt);
      }
      pendk[i] = k; pendv[i] = v;
    }
    new_len = sp_start;
    move_off = n_imm + s;
    scatter = scatter || spill_cnt > 0;
  } else {
    for (int i = tid; i < SC; i += nt) { nsk[i] = sk[i]; nsv[i] = sv[i]; }
    for (int i = tid; i < A; i += nt) {
      pendk[i] = ad.large_k(i); pendv[i] = ad.large_v(i);
    }
  }
  // removal stream: the eliminated prefix, then the consumed merge prefix
  for (int r = tid; r < R; r += nt) {
    float k = INF; int v = kEmptyVal;
    if (r < rmc && r < n_imm) { k = ad.aks(min(r, A - 1)); v = ad.avs(min(r, A - 1)); }
    const int rel = r - n_imm;
    if (combine && rel >= 0 && rel < s) {
      const int q = min(rel, M - 1);
      k = mk[q]; v = mv[q];
    }
    rmk[r] = k; rmv[r] = v;
  }
  __syncthreads();   // pend is read by every thread below

  // ---- scatter: SL::addPar() segment append (the rows are written by
  // rows_kernel); an overflow discards it and asks for the rebalance ----
  float kmin = INF;
  c = 0;
  for (int i = tid; i < A; i += nt) {
    const float k = pendk[i];
    if (k < INF) { ++c; kmin = fminf(kmin, k); }
  }
  const int n_pend = block_sum(c, red);
  kmin = block_min(kmin, redf);
  float par_min = a.par_min[l];
  int par_count = a.par_count[l];
  bool applied = false, rebal = false;
  if (scatter) {
    c = 0;
    for (int b = tid; b < NB; b += nt) {
      const int start = b == 0 ? 0 : count_less(pendk, A, spl[b]);
      const int end = count_less(pendk, A, b + 1 < NB ? spl[b + 1] : INF);
      const int nc = bcin[b] + end - start;
      seg_start[b] = start;
      new_counts[b] = nc;
      c += nc > BC;
    }
    const bool overflow = block_sum(c, red) > 0;
    applied = !overflow;
    rebal = overflow;
    if (applied) {
      par_min = fminf(par_min, kmin);
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
    for (int b = tid; b < NB; b += nt) c += applied ? new_counts[b] : bcin[b];
    const int total = block_sum(c, red);
    k = min(min(k_extract, total), a.K);
    int carry = 0;
    for (int base = 0; base < NB; base += nt) {
      const int b = base + tid;
      const int cnt = b < NB ? (applied ? new_counts[b] : bcin[b]) : 0;
      int chunk;
      const int off = carry + block_excl_scan(cnt, red, &chunk);
      if (b < NB) {
        const int ns = min(max(k - off, 0), cnt);
        offs[b] = off;
        nsel[b] = ns;
        a.pbc[(size_t)l * NB + b] = cnt - ns;
      }
      carry += chunk;
    }
  } else {
    for (int b = tid; b < NB; b += nt)
      a.pbc[(size_t)l * NB + b] = applied ? new_counts[b] : bcin[b];
  }
  for (int b = tid; b < NB; b += nt) a.psp[(size_t)l * NB + b] = spl[b];

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
    a.n_par_adds[l] = n_par_adds;
    a.spilled[l] = combine && spill_cnt > 0;
    a.n_rm_par[l] = move_sel ? served : 0;
    a.n_drop_rep[l] = 0;
    a.detach_out[l] = move ? nd : d;
    a.ins_out[l] = move ? 0 : ins;
    a.quiet_out[l] = quiet;
  }
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
      mn = fminf(mn, k);
    }
    out_k[s] = k; out_v[s] = v;
  }
  mn = block_min(mn, redf);
  if (tid == 0) a.rowmin[row] = mn;
}

// ---- launch 3: the moveHead serve and the fresh sequential part ----------

__global__ void __launch_bounds__(kHeadThreads) move_kernel(Args a) {
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
  for (int b = tid; b < NB; b += nt) mn = fminf(mn, a.rowmin[(size_t)l * NB + b]);
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
// detach_max, halve_thr, double_thr.  in/out/ws: device pointers in the
// wrapper's order.  Returns the CUDA error of the launches (0 = success).
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

  a.mk = (float*)ws[0]; a.mv = (int*)ws[1]; a.mf = (int*)ws[2];
  a.seg_start = (int*)ws[3]; a.new_counts = (int*)ws[4];
  a.offs = (int*)ws[5]; a.nsel = (int*)ws[6]; a.rowmin = (float*)ws[7];
  a.selk = (float*)ws[8]; a.selv = (int*)ws[9]; a.lane_ws = (int*)ws[10];

  a.L = (int)dims[0]; a.A = (int)dims[1]; a.R = (int)dims[2];
  a.SC = (int)dims[3]; a.NB = (int)dims[4]; a.BC = (int)dims[5];
  a.K = (int)dims[6]; a.spill_thr = (int)dims[7];
  a.chop_patience = (int)dims[8]; a.detach_min = (int)dims[9];
  a.detach_max = (int)dims[10]; a.halve_thr = (int)dims[11];
  a.double_thr = (int)dims[12];

  cudaStream_t st = (cudaStream_t)stream;
  head_kernel<<<a.L, kHeadThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
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

  move_kernel<<<a.L, kHeadThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

const char* lane_tick_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
