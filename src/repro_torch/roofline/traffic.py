"""The bytes a queue kernel launch or engine tick must move, from its
config and shapes (the port's stand-in for the reference's
``roofline/hlo_stats.py``, which reads them off compiled HLO).

Each count takes every input the work must read once and every output
it must write once, so it is the same whatever implements the work —
the CUDA kernel, its plain twin, or a later redesign — and it stays a
lower bound: no device time may fall under ``bound_s()``.

* A lane's state is every leaf of its ``PQState`` (the sequential part,
  the bucket store, the paper scalars and the 15 stats counters).  An
  engine tick returns a new state beside the old one, which its caller
  may keep, so it reads every leaf and writes the new one.
* An op batch of width W is W keys (f32), vals (i32) and mask bytes and
  the removeMin count; a removal stream of width W is W keys, vals and
  served flags.
* The lane-tick kernel (K3) at grid L counts what L lanes' hot ticks
  must touch with the state updated in place, not the state it copies
  today: per lane the [a_max] batch and the grant in, the [r_max]
  removal stream and its count out, the scalars and stats and the
  bucket counts in and out, the splitters in; then each add written
  once (to the sequential part or a bucket), each removal read once,
  and each slot a moveHead detaches read from the buckets and written
  to the sequential part.  Given the launch's own counts of these, it
  is what that launch's data needs; without them, a full tick: a_max
  adds, r_max removals and a moveHead of min(seq_cap, move_k_max)
  slots in every lane.
* The sorts and merges (K2, K1) read keys, vals and flags (4 bytes
  each) and write them back in order; the radix select (K4) reads the
  keys and k and writes (tau, n_below).
* A mesh tick (``engine="dist"``) moves what the sharded tick moves,
  plus, over the links, the all-gather of every position's lane heads
  and sizes (``core.distributed._all_gather``: L × 8 bytes gathered).

Queue work is comparisons, not FLOPs: no count carries a FLOP term.

The model stack's serving steps (``model_prefill``, ``model_decode``)
count the weights each step must read once (from the parameter tree's
shapes: ``init_params`` on the meta device), the cache bytes it must
read or write once, and its logits; ``model_step_flops`` counts the
FLOPs of its products, and ``model_bound_s`` weighs both against the
card's rates.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.roofline.analysis import Roofline

_WORD = 4          # f32 / i32
_FLAG = 1          # bool
_KVF = 3 * _WORD   # key, val, flag of the kernel ops
_STATS = 15        # PQStats counters


class Traffic(NamedTuple):
    """Bytes through HBM and over the card-to-card links."""

    hbm_bytes: int
    link_bytes: int = 0

    def bound_s(self) -> float:
        """Least seconds the card could take: the larger of the memory
        and link terms."""
        return Roofline.from_measurements(
            0.0, self.hbm_bytes, self.link_bytes).bound_step_time()


def lane_state_bytes(cfg) -> int:
    """Bytes of one lane's ``PQState`` under a ``PQConfig``."""
    seq = cfg.seq_cap * 2 * _WORD + _WORD               # keys, vals, len
    store = (cfg.n_buckets * cfg.bucket_cap * 2 * _WORD  # buckets, bvals
             + cfg.n_buckets * 2 * _WORD                 # bcounts, splitters
             + 2 * _WORD)                                # par_min, par_count
    scalars = 5 * _WORD      # min_value last_seq detach_n ins_since quiet
    return seq + store + scalars + _STATS * _WORD


def batch_bytes(width: int) -> int:
    """An op batch: keys, vals, mask, and the removeMin count."""
    return width * (2 * _WORD + _FLAG) + _WORD


def result_bytes(width: int) -> int:
    """A removal stream: keys, vals, served flags."""
    return width * (2 * _WORD + _FLAG)


def k3_launch(cfg, lanes: int, adds=None, removals=None,
              detached=None) -> Traffic:
    """The lane-tick kernel over ``lanes`` lanes of config ``cfg``, whose
    batches hold ``adds`` keys in all, which serve ``removals`` keys and
    whose moveHeads detach ``detached`` slots into fresh sequential
    parts (default: a full tick in every lane)."""
    if adds is None:
        adds = lanes * cfg.a_max
    if removals is None:
        removals = lanes * cfg.r_max
    if detached is None:
        detached = lanes * min(cfg.seq_cap, cfg.move_k_max)
    scalars = (1 + 2 + 5 + _STATS) * _WORD   # seq_len, par, paper, stats
    per = (batch_bytes(cfg.a_max)                          # batch, grant
           + cfg.r_max * 2 * _WORD + _WORD                 # removals, count
           + 2 * scalars + 2 * cfg.n_buckets * _WORD       # in and out
           + cfg.n_buckets * _WORD)                        # splitters
    slot = 2 * _WORD                                       # key, val
    return Traffic(lanes * per + (adds + removals + 2 * detached) * slot)


def k2_sort(rows: int, width: int) -> Traffic:
    """The stable row co-sort of [rows, width] (keys, vals, flags)."""
    return Traffic(2 * rows * width * _KVF)


def k1_merge(rows: int, n_a: int, n_b: int) -> Traffic:
    """The merge of sorted [rows, n_a] and [rows, n_b] streams."""
    return Traffic(2 * rows * (n_a + n_b) * _KVF)


def k4_select(rows: int, n: int) -> Traffic:
    """The radix select over [rows, n] keys: k in, (tau, n_below) out."""
    return Traffic(rows * (n * _WORD + _WORD + 2 * _WORD))


def select_k_smallest(rows: int, n: int, k_max: int) -> Traffic:
    """K4 then K2 over [rows, n] keys and vals: the k_max smallest out."""
    return Traffic(rows * (n + k_max) * 2 * _WORD)


def extract_k_bucketed(n_buckets: int, bucket_cap: int,
                       k_max: int) -> Traffic:
    """moveHead's extraction from an [n_buckets, bucket_cap] store: the
    store (keys, vals, counts) in and out, the splitters in, k_max keys
    and vals out."""
    store = n_buckets * bucket_cap * 2 * _WORD + n_buckets * _WORD
    return Traffic(2 * store + n_buckets * _WORD + k_max * 2 * _WORD)


def pqe_tick(cfg) -> Traffic:
    """One tick of the combined queue (``PQConfig``)."""
    return Traffic(2 * lane_state_bytes(cfg) + batch_bytes(cfg.a_max)
                   + result_bytes(cfg.r_max))


def sharded_state_bytes(cfg) -> int:
    """Bytes of a ``ShardedState`` (``ShardedPQConfig``): the L lanes,
    the router's generator state [2] i64, route and route_inv [a_total]
    i32, and seven scalars."""
    return (cfg.n_lanes * lane_state_bytes(cfg.lane) + 2 * 2 * _WORD
            + 2 * cfg.a_total * _WORD + 7 * _WORD)


def sharded_tick(cfg) -> Traffic:
    """One tick of the L-lane queue (``ShardedPQConfig``); its removal
    stream is max(a_total, L * lane.r_max) wide."""
    out_w = max(cfg.a_total, cfg.n_lanes * cfg.lane.r_max)
    return Traffic(2 * sharded_state_bytes(cfg) + batch_bytes(cfg.a_total)
                   + result_bytes(out_w))


def dist_tick(cfg) -> Traffic:
    """One tick of the mesh queue (``DistShardedPQConfig``), all
    positions together: the sharded tick's HBM bytes, and over the links
    the L lane heads (f32) and sizes (i32) the all-gather assembles."""
    return Traffic(sharded_tick(cfg.shard).hbm_bytes,
                   cfg.shard.n_lanes * 2 * _WORD)


# ---------------------------------------------------------------------------
# the model stack's serving steps
# ---------------------------------------------------------------------------

def _meta_params(cfg):
    """The parameter tree's shapes and dtypes (meta tensors: no memory)."""
    from repro_torch.models import transformer as tf
    return tf.init_params(cfg, None, "meta")


def _leaf_paths(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{path}.{k}")
        else:
            yield f"{path}.{k}", v


def weight_bytes(cfg, rows: int, experts=None) -> int:
    """Bytes of the weights a serving step reads once: every parameter,
    but an untied embedding table only at the ``rows`` token rows it
    gathers (a tied table is read whole by the unembedding) and, with
    ``experts``, each MoE layer's expert weights at that many experts."""
    total = 0
    for path, t in _leaf_paths(_meta_params(cfg)):
        n = t.numel() * t.element_size()
        if path == ".embed" and not cfg.tie_embeddings:
            n = min(rows, t.shape[0]) * t.shape[1] * t.element_size()
        elif experts is not None and ".moe.w" in path:
            n = n * experts // cfg.n_experts
        total += n
    return total


def model_step_flops(cfg, tokens: int, logits_rows: int) -> float:
    """A lower bound on a serving step's FLOPs: 2 per weight of the
    decoder stack's products for each of ``tokens`` tokens (an MoE layer
    at its top_k experts; a shared attention block once per use), and 2
    per unembedding weight for each of ``logits_rows`` logits rows.
    Left out: embedding lookups, attention's score products, norms and
    an enc-dec arch's encoder and cross K/V."""
    tree = _meta_params(cfg)
    per_token = 0
    uses = cfg.pattern_reps * cfg.layer_pattern.count("A")
    for path, t in _leaf_paths({k: tree[k] for k in ("stack", "shared_attn")
                                if k in tree}):
        if path.startswith(".stack") and t.dim() < 3:
            continue                   # norms, biases: [reps, n]
        n = t.numel()
        if ".moe.w" in path:
            n = n * cfg.top_k // cfg.n_experts
        elif path.startswith(".shared_attn"):
            n *= uses
        per_token += n
    return 2.0 * (per_token * tokens
                  + cfg.vocab_padded * cfg.d_model * logits_rows)


def _state_bytes(cfg, batch: int) -> int:
    """Recurrent state (SSM / xLSTM blocks) of every layer, all rows."""
    item = 2 if cfg.dtype == "bfloat16" else 4
    per = {"M": ((cfg.conv_dim - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
                 * item + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                 * _WORD),
           "X": (cfg.d_model * cfg.d_model // cfg.n_heads + cfg.d_model
                 + cfg.n_heads) * _WORD,
           "S": 4 * cfg.d_model * _WORD}
    return batch * cfg.pattern_reps * sum(per.get(k, 0)
                                          for k in cfg.layer_pattern)


def _kv_bytes(cfg, slots: int) -> int:
    """K and V of ``slots`` (row, position) pairs in every attention
    layer (enc-dec: the decoder's self-attention)."""
    item = 2 if cfg.dtype == "bfloat16" else 4
    n_attn = cfg.pattern_reps * sum(k in "GLA" for k in cfg.layer_pattern)
    return n_attn * slots * 2 * cfg.n_kv_heads * cfg.head_dim * item


def _cross_bytes(cfg, batch: int) -> int:
    """An enc-dec arch's cross K/V of every decoder layer."""
    if not cfg.enc_dec:
        return 0
    item = 2 if cfg.dtype == "bfloat16" else 4
    return (cfg.pattern_reps * batch * cfg.enc_seq * 2 * cfg.n_kv_heads
            * cfg.head_dim * item)


def model_prefill(cfg, batch: int, seq: int) -> Traffic:
    """One prefill of ``batch`` prompts of ``seq`` positions: the weights
    read once (``weight_bytes``), the K/V of every position, the
    recurrent states and an enc-dec arch's cross K/V written once, the
    tokens in, the last position's f32 logits out."""
    return Traffic(weight_bytes(cfg, batch * seq)
                   + _kv_bytes(cfg, batch * seq) + _state_bytes(cfg, batch)
                   + _cross_bytes(cfg, batch) + batch * seq * _WORD
                   + batch * cfg.vocab_padded * _WORD)


def model_decode(cfg, batch: int, attended: int) -> Traffic:
    """One decode step of ``batch`` rows attending ``attended`` cache
    slots in all (each row its position + 1): the weights read once (an
    MoE layer at least its top_k experts), those K/V slots and an
    enc-dec arch's cross K/V read, the recurrent states read and written,
    the tokens in and the f32 logits out."""
    experts = cfg.top_k if cfg.family == "moe" else None
    return Traffic(weight_bytes(cfg, batch, experts)
                   + _kv_bytes(cfg, attended) + 2 * _state_bytes(cfg, batch)
                   + _cross_bytes(cfg, batch) + batch * _WORD
                   + batch * cfg.vocab_padded * _WORD)


def model_bound_s(count: Traffic, flops: float) -> float:
    """Least seconds for a serving step: the larger of its bytes over
    the HBM rate and ``flops`` (``model_step_flops``) over the bf16
    peak."""
    return Roofline.from_measurements(flops, count.hbm_bytes,
                                      0.0).bound_step_time()


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _param_bytes(cfg) -> tuple:
    """(parameter count, parameter bytes) of the whole tree."""
    leaves = list(t for _, t in _leaf_paths(_meta_params(cfg)))
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def model_train(cfg, batch: int, seq: int, n_micro: int, remat: bool,
                opt_8bit: bool):
    """One training step of ``batch`` x ``seq`` tokens in ``n_micro``
    microbatches (``launch.train.make_train_step``).  Returns (Traffic,
    FLOPs).

    FLOPs: the forward's products (``model_step_flops``, every position
    a logits row) times 3 (forward, and the backward's two products a
    weight), times 4 under ``remat`` (the forward once more).  Bytes, a
    microbatch: the weights read in each pass (two, three under remat;
    an untied table at its gathered rows), the gradients in the
    parameter dtype written and read, the float32 accumulator read and
    written; then once a step the accumulator read, the moments (float32,
    or the 8-bit codes and their block scales) and the parameters read
    and written, and the tokens and labels in.  Activations are left
    out: a lower bound."""
    n = min(n_micro, batch)
    micro_tokens = (batch // n) * seq
    passes = 3 if remat else 2
    count, pbytes = _param_bytes(cfg)
    per_micro = (passes * weight_bytes(cfg, micro_tokens)
                 + 2 * pbytes + 2 * _WORD * count)
    moments = (2 * (1 + _WORD / 256) if opt_8bit else 2 * _WORD) * count
    hbm = (n * per_micro + _WORD * count + 2 * moments + 2 * pbytes
           + 2 * batch * seq * _WORD)
    flops = (4 if remat else 3) * model_step_flops(cfg, batch * seq,
                                                   batch * seq)
    return Traffic(int(hbm)), flops
