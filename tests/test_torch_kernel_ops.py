"""K1, K2 and K4 and their compositions in the port's kernel ops, against
the JAX package on the CPU.

The port's ops run under the "cuda" backend on CPU tensors, so each kernel
wrapper takes its plain version inside the kernel composition; the JAX
side runs its kernels in interpret mode (``_PALLAS``), its jnp branches
(``_JNP``) and its oracles (``ref.py``).  Inputs come from numpy with
fixed seeds.  Everything is bit for bit except where the reference's
Pallas sort is unstable: there keys match bit for bit and each row's
(key, val, flag) multiset matches.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitonic import bitonic_sort_kvf as j_bitonic
from repro.kernels.merge_consume import merge_sorted_kvf as j_merge
from repro.kernels.radix_select import radix_select_threshold as j_radix
from repro_torch.kernels import bitonic, merge_consume, radix_select
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# resolved once, config-style: no call site below passes a string
_JNP = jops.resolve_backend("jnp")
_PALLAS = jops.resolve_backend("pallas")
CUDA = tops.resolve_backend("cuda")
TORCH = tops.resolve_backend("torch")

# the JAX side, jitted: one compile per shape instead of one per op
_j_sort_jnp = jax.jit(functools.partial(jops.sort_kvf, backend=_JNP))
_j_corank = jax.jit(jops._merge_sorted_corank)
_j_ref_select_threshold = jax.jit(jref.ref_select_threshold)
_j_ref_select_k = jax.jit(jref.ref_select_k, static_argnums=3)
_j_ref_extract = jax.jit(jref.ref_extract_k_bucketed, static_argnums=4)


@functools.lru_cache(maxsize=None)
def _j_extract_pallas(k_max):
    return jax.jit(functools.partial(jops.extract_k_bucketed, k_max=k_max,
                                     backend=_PALLAS))


@functools.lru_cache(maxsize=None)
def _j_select_k_pallas(k_max):
    return jax.jit(functools.partial(jops.select_k_smallest, k_max=k_max,
                                     backend=_PALLAS))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype, (msg, g.dtype, w.dtype)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _keys(rng, shape, dist):
    k = rng.uniform(-50, 50, shape).astype(np.float32)
    n = shape[-1]
    if dist == "dups":
        k[..., : n // 2] = 7.0
    elif dist == "inf_pad":
        k[rng.random(shape) < 0.3] = np.inf
    elif dist == "negative":
        k = -np.abs(k)
    elif dist == "signed_zero":
        k = rng.choice(np.array([0.0, -0.0, 1.5, -2.0, np.inf], np.float32),
                       shape)
    elif dist == "all_equal":
        k[...] = 7.0
    return k


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

def test_resolve_backend():
    assert tops.resolve_backend("cuda") == CUDA and CUDA.is_cuda
    assert tops.resolve_backend("torch") == TORCH and not TORCH.is_cuda
    assert tops.resolve_backend(TORCH) is TORCH
    for bad in ("jnp", "pallas", "auto", None):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            tops.resolve_backend(bad)


@pytest.mark.parametrize("op", ["sort_kvf", "merge_sorted",
                                "select_threshold", "select_k_smallest",
                                "extract_k_bucketed"])
def test_ops_default_to_the_cuda_backend(op):
    import inspect
    assert inspect.signature(getattr(tops, op)).parameters[
        "backend"].default == CUDA


@pytest.mark.parametrize("wrapper,nargs", [
    (bitonic.bitonic_sort_kvf, 3), (merge_consume.merge_sorted_kvf, 6),
    (radix_select.radix_select_threshold, 2)])
def test_wrappers_raise_off_cpu_and_cuda(wrapper, nargs):
    x = torch.empty((1, 4), device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        wrapper(*([x] * nargs))


def test_engine_never_reaches_the_kernel_wrappers(monkeypatch):
    """The engine's passes take the plain branch explicitly, as every
    engine path of the reference runs the jnp branch: a tick that fires
    every pass calls none of K1, K2 and K4."""
    from repro_torch.core import PQConfig, pqueue

    def refuse(*args):
        raise AssertionError("an engine path reached a kernel wrapper")

    monkeypatch.setattr(bitonic, "bitonic_sort_kvf", refuse)
    monkeypatch.setattr(merge_consume, "merge_sorted_kvf", refuse)
    monkeypatch.setattr(radix_select, "radix_select_threshold", refuse)
    w = 16
    cfg = PQConfig(a_max=w, r_max=w, seq_cap=64, n_buckets=4, bucket_cap=8,
                   detach_min=4, detach_max=16, detach_init=4,
                   chop_patience=2, backend="torch")
    state = pqueue.init(cfg, "cpu")
    rng = np.random.default_rng(3)
    fired = np.zeros(5, np.int64)
    for t in range(24):
        n_add = w if t % 6 < 3 else 0
        keys = np.full(w, np.inf, np.float32)
        keys[:n_add] = rng.uniform(0, 100, n_add)
        mask = np.arange(w) < n_add
        rm = (w if t // 6 % 2 else 2) if t % 6 == 3 else 0
        state, res = pqueue.tick(cfg, state, _t(keys),
                                 _t(np.arange(w, dtype=np.int32)), _t(mask),
                                 rm)
        fired += res.repairs.numpy()
    assert fired.all(), fired.tolist()


# ---------------------------------------------------------------------------
# the plain oracles (ref.py) against the reference's
# ---------------------------------------------------------------------------

def test_ref_oracles_match_reference():
    rng = np.random.default_rng(21)
    keys = rng.choice(np.array([0.0, -0.0, 1.0, 2.5, np.inf, -3.0],
                               np.float32), (3, 40))
    vals = rng.integers(-9, 1 << 30, (3, 40)).astype(np.int32)
    flags = rng.integers(0, 2, (3, 40)).astype(np.int32)
    for g, w in zip(tref.ref_sort_kvf(_t(keys), _t(vals), _t(flags)),
                    jref.ref_sort_kvf(_j(keys), _j(vals), _j(flags))):
        _eq(g, w, "ref_sort_kvf")
    a, b = np.sort(keys[0]), np.sort(keys[1][:25])
    args = (a, vals[0], flags[0], b, vals[1][:25], flags[1][:25])
    for g, w in zip(tref.ref_merge_sorted(*map(_t, args)),
                    jref.ref_merge_sorted(*map(_j, args))):
        _eq(g, w, "ref_merge_sorted")
    flat = keys.reshape(-1)
    for k in (0, 1, 7, 60, 120):
        for g, w in zip(tref.ref_select_threshold(_t(flat), k),
                        _j_ref_select_threshold(_j(flat), k)):
            _eq(g, w, f"ref_select_threshold k={k}")
        for g, w in zip(tref.ref_select_k(_t(flat), _t(vals.reshape(-1)), k,
                                          64),
                        _j_ref_select_k(_j(flat), _j(vals.reshape(-1)), k,
                                        64)):
            _eq(g, w, f"ref_select_k k={k}")
    counts = np.array([40, 3, 17], np.int32)
    for k in (0, 5, 80):
        for g, w in zip(
                tref.ref_extract_k_bucketed(_t(keys), _t(vals), _t(counts),
                                            k, 48),
                _j_ref_extract(_j(keys), _j(vals), _j(counts), k, 48)):
            _eq(g, w, f"ref_extract_k_bucketed k={k}")


# ---------------------------------------------------------------------------
# K2: the stable row co-sort
# ---------------------------------------------------------------------------

_DISTS = ["uniform", "dups", "inf_pad", "negative", "signed_zero",
          "all_equal"]


@pytest.mark.parametrize("n", [1, 8, 31, 64, 256, 1000, 4097])
@pytest.mark.parametrize("key_dist", _DISTS)
def test_sort_kvf_matches_jnp_branch(n, key_dist):
    """Bit for bit, at any length (1, 31, 1000 and 4097 are not powers of
    two; 4097 is one past the kernel's one-CTA rows), and stable (all keys
    equal keeps vals and flags in input order)."""
    rng = np.random.default_rng(n + 7 * _DISTS.index(key_dist))
    rows = 4
    keys = _keys(rng, (rows, n), key_dist)
    vals = rng.integers(-5, 1 << 30, (rows, n)).astype(np.int32)
    flags = rng.integers(0, 2, (rows, n)).astype(np.int32)
    got = tops.sort_kvf(_t(keys), _t(vals), _t(flags), backend=CUDA)
    want = _j_sort_jnp(_j(keys), _j(vals), _j(flags))
    for g, w in zip(got, want):
        _eq(g, w, f"n={n} {key_dist}")
    # the leading dims fold onto the kernel's rows
    got3 = tops.sort_kvf(*(_t(x.reshape(2, 2, n)) for x in (keys, vals,
                                                            flags)),
                         backend=CUDA)
    for g3, g in zip(got3, got):
        _eq(g3.reshape(rows, n), g)


@pytest.mark.parametrize("rows,n", [(1, 8), (4, 64), (2, 256)])
@pytest.mark.parametrize("key_dist", ["uniform", "dups", "inf_pad",
                                      "negative"])
def test_bitonic_matches_pallas_keys_and_multisets(rows, n, key_dist):
    """The reference's network is unstable: keys bit for bit, and each
    row's (key, val, flag) multiset equal."""
    rng = np.random.default_rng(rows * n + 3 * len(key_dist))
    keys = _keys(rng, (rows, n), key_dist)
    vals = rng.integers(0, 1 << 20, (rows, n)).astype(np.int32)
    flags = rng.integers(0, 2, (rows, n)).astype(np.int32)
    got = bitonic.bitonic_sort_kvf(_t(keys), _t(vals), _t(flags))
    want = j_bitonic(_j(keys), _j(vals), _j(flags))
    _eq(got[0], want[0])
    for r in range(rows):
        g = sorted(zip(*(_bits(x)[r].tolist() for x in got)))
        w = sorted(zip(*(_bits(x)[r].tolist() for x in want)))
        assert g == w, (rows, n, key_dist, r)


# ---------------------------------------------------------------------------
# K1: the rank merge
# ---------------------------------------------------------------------------

def _merge_inputs(rng, lead, n, m, signed_zero):
    pool = np.array([0.0, 1.0, 2.0, 2.0, 9.0, -4.0], np.float32)
    if signed_zero:
        pool = np.append(pool, np.float32(-0.0))
    ak = np.sort(rng.choice(pool, lead + (n,)), -1)
    bk = np.sort(rng.choice(pool, lead + (m,)), -1)
    ak[..., -(n // 7 + 1):] = np.inf
    bk[..., -(m // 5 + 1):] = np.inf
    return ak, bk


@pytest.mark.parametrize("lead", [(), (4,)])
@pytest.mark.parametrize("n,m", [(37, 20), (1024, 512), (5, 300)])
def test_merge_sorted_matches_corank(lead, n, m):
    """Cross-stream ties a-first, INF padding, -0.0 beside 0.0, payloads
    past 2**24 and odd totals: bit for bit with the co-rank merge."""
    rng = np.random.default_rng(n * 31 + m + len(lead))
    ak, bk = _merge_inputs(rng, lead, n, m, signed_zero=True)
    av = rng.integers(1 << 24, 1 << 30, lead + (n,)).astype(np.int32)
    bv = rng.integers(-(1 << 30), 0, lead + (m,)).astype(np.int32)
    af = rng.integers(0, 2, lead + (n,)).astype(np.int32)
    bf = rng.integers(0, 2, lead + (m,)).astype(np.int32)
    args = (ak, av, af, bk, bv, bf)
    got = tops.merge_sorted(*map(_t, args), backend=CUDA)
    want = _j_corank(*map(_j, args))
    for g, w in zip(got, want):
        _eq(g, w, f"lead={lead} n={n} m={m}")


@pytest.mark.parametrize("n,m,tile", [(256, 256, 256), (96, 32, 32),
                                      (1024, 512, 256)])
def test_merge_matches_pallas_merge(n, m, tile):
    """Where the reference's one-hot merge is exact (no -0.0, |val| <
    2**24, the total a multiple of the tile) it equals K1 bit for bit."""
    rng = np.random.default_rng(n + m + tile)
    ak, bk = _merge_inputs(rng, (), n, m, signed_zero=False)
    av = rng.integers(0, 1 << 24, n).astype(np.int32)
    bv = rng.integers(0, 1 << 24, m).astype(np.int32)
    af = np.zeros(n, np.int32)
    bf = np.ones(m, np.int32)
    args = (ak, av, af, bk, bv, bf)
    got = merge_consume.merge_sorted_kvf(*(_t(x[None]) for x in args))
    want = j_merge(*map(_j, args), tile=tile)
    for g, w in zip(got, want):
        _eq(g[0], w)


# ---------------------------------------------------------------------------
# K4: the radix threshold select
# ---------------------------------------------------------------------------

def _radix_both(keys, k):
    """(port plain version, reference kernel) on one stream."""
    got = radix_select.radix_select_threshold(
        _t(keys.reshape(1, -1)), _t(np.array([k], np.int32)))
    want = j_radix(_j(keys), k)
    return (got[0][0], got[1][0]), want


def _radix_eq(keys, k, msg=""):
    (gt, gn), (wt, wn) = _radix_both(keys, k)
    assert _bits(gt) == _bits(wt), (msg, k, float(gt), float(wt))
    assert int(gn) == int(wn), (msg, k, int(gn), int(wn))


@pytest.mark.parametrize("length", [32, 256, 4096])
def test_radix_select_matches_reference(length):
    """tests/test_kernels.py's threshold sweep, bit for bit."""
    rng = np.random.default_rng(length)
    for trial in range(3):
        nfin = int(rng.integers(1, length + 1))
        keys = np.full(length, np.inf, np.float32)
        keys[:nfin] = rng.uniform(-100, 100, nfin).astype(np.float32)
        if nfin > 8:
            keys[2:6] = keys[1]   # duplicates around the threshold
        rng.shuffle(keys)
        for k in [0, 1, nfin // 2, nfin]:
            _radix_eq(keys, k, f"L={length} trial {trial}")


@pytest.mark.parametrize("length", [64, 1024])
def test_radix_select_edges_match_reference(length):
    """k = 0, all-INF streams, negative keys, k past the finite count,
    and k past the stream itself."""
    rng = np.random.default_rng(length + 1)
    keys = rng.uniform(-5, 5, length).astype(np.float32)
    _radix_eq(keys, 0, "k=0")
    inf_keys = np.full(length, np.inf, np.float32)
    for k in (1, length // 2, length):
        _radix_eq(inf_keys, k, "all INF")
    neg = -np.abs(rng.uniform(0.5, 100, length)).astype(np.float32)
    for k in (1, 7, length):
        _radix_eq(neg, k, "negative")
    half = np.full(length, np.inf, np.float32)
    half[: length // 2] = rng.uniform(0, 10, length // 2)
    _radix_eq(half, length, "k past the finite count")
    (tau, nb), _ = _radix_both(half, length)
    assert float(tau) == np.inf and int(nb) == length // 2
    _radix_eq(keys, length + 3, "k past the stream")


def test_radix_select_signed_zeros_match_reference():
    """-0.0 orders strictly below 0.0 in the kernel, as in the
    reference's kernel (its ref oracle ties them instead)."""
    rng = np.random.default_rng(9)
    keys = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, np.inf], np.float32),
                      300)
    for k in range(0, 301, 13):
        _radix_eq(keys, k, "signed zeros")
    n_neg = int((keys == -1.0).sum())
    n_mz = int(((keys == 0) & np.signbit(keys)).sum())
    (tau, nb), _ = _radix_both(keys, n_neg + n_mz + 1)
    assert _bits(tau) == 0 and int(nb) == n_neg + n_mz   # +0.0


def test_radix_select_rows_are_independent_streams():
    """A [B, L] batch with one k per row equals each row alone; a
    flattened [NB, BCAP] store is one stream, as the reference takes it."""
    rng = np.random.default_rng(5)
    store = rng.uniform(0, 100, (8, 32)).astype(np.float32)
    store[rng.random((8, 32)) < 0.4] = np.inf
    rows = np.stack([store.reshape(-1), -store.reshape(-1),
                     np.sort(store.reshape(-1))])
    ks = np.array([17, 200, 0], np.int32)
    tau, nb = tops.select_threshold(_t(rows), _t(ks), backend=CUDA)
    for r in range(3):
        wt, wn = j_radix(_j(rows[r]), int(ks[r]))
        assert _bits(tau[r]) == _bits(wt) and int(nb[r]) == int(wn)
    wt, wn = j_radix(_j(store), 17)
    assert _bits(tau[0]) == _bits(wt) and int(nb[0]) == int(wn)
    # a scalar k serves every row
    tau_s, nb_s = radix_select.radix_select_threshold(_t(rows), 17)
    for r in range(3):
        wt, wn = j_radix(_j(rows[r]), 17)
        assert _bits(tau_s[r]) == _bits(wt) and int(nb_s[r]) == int(wn)


# ---------------------------------------------------------------------------
# the compositions: select_k_smallest and extract_k_bucketed
# ---------------------------------------------------------------------------

def _pairs(k, v):
    return sorted(zip(_bits(k).tolist(), _np(v).tolist()))


@pytest.mark.parametrize("k", [0, 1, 17, 64])
def test_select_k_smallest_matches_reference(k):
    rng = np.random.default_rng(k)
    length, k_max = 512, 64
    keys = rng.uniform(0, 1000, length).astype(np.float32)
    keys[rng.random(length) < 0.1] = np.inf
    keys[:40:3] = keys[40]    # ties at and around the threshold
    vals = np.arange(length, dtype=np.int32)
    gk, gv = tops.select_k_smallest(_t(keys), _t(vals), k, k_max,
                                    backend=CUDA)
    pk, pv = _j_select_k_pallas(k_max)(_j(keys), _j(vals), k)
    _eq(gk, pk, f"k={k}")
    assert _pairs(gk, gv) == _pairs(pk, pv)
    ek, ev = _j_ref_select_k(_j(keys), _j(vals), k, k_max)
    _eq(gk, ek, f"k={k}")
    _eq(gv, ev, f"k={k}")       # K2 is stable: ties keep stream order


def test_select_k_smallest_tie_split_and_any_k_max():
    keys = np.array([5.0, 3.0, 5.0, 1.0, 5.0, 5.0, 2.0, 5.0], np.float32)
    vals = np.arange(8, dtype=np.int32)
    gk, gv = tops.select_k_smallest(_t(keys), _t(vals), 5, 6, backend=CUDA)
    _eq(gk, np.array([1.0, 2.0, 3.0, 5.0, 5.0, np.inf], np.float32))
    _eq(gv, np.array([3, 6, 1, 0, 2, -1], np.int32))
    for k in (0, 3, 8):
        ek, ev = _j_ref_select_k(_j(keys), _j(vals), k, 6)
        gk, gv = tops.select_k_smallest(_t(keys), _t(vals), k, 6,
                                        backend=CUDA)
        _eq(gk, ek, f"k={k}")
        _eq(gv, ev, f"k={k}")


def _bucket_store(rng, nb, bc):
    splitters = np.full(nb, np.inf, np.float32)
    edges = np.sort(rng.uniform(0, 100, nb - 1)).astype(np.float32)
    splitters[0] = -np.inf
    splitters[1:] = edges
    keys = np.full((nb, bc), np.inf, np.float32)
    vals = np.full((nb, bc), -1, np.int32)
    counts = rng.integers(0, bc + 1, nb).astype(np.int32)
    lo = np.concatenate([[0.0], edges])
    hi = np.concatenate([edges, [100.0]])
    nv = 0
    for r in range(nb):
        keys[r, :counts[r]] = rng.uniform(lo[r], hi[r], counts[r])
        vals[r, :counts[r]] = np.arange(nv, nv + counts[r])
        nv += counts[r]
    # stale slots past each count must be ignored
    keys[:, -1] = np.where(counts < bc, -7.0, keys[:, -1])
    return keys, vals, counts, splitters


def _check_extract(got, keys, vals, counts, k, k_max, splitters=None,
                   pallas=True):
    args = (_j(keys), _j(vals), _j(counts), k)
    if pallas:
        want = _j_extract_pallas(k_max)(
            *args, splitters=None if splitters is None else _j(splitters))
        _eq(got[0], want[0], f"out_k k={k}")
        assert _pairs(got[0], got[1]) == _pairs(want[0], want[1])
        for i in (2, 3, 4):
            _eq(got[i], want[i], f"store leaf {i} k={k}")
    ek, ev = _j_ref_extract(*args, k_max)
    _eq(got[0], ek, f"out_k vs ref k={k}")
    _eq(got[1], ev, f"out_v vs ref k={k}")


@pytest.mark.parametrize("pruned", [True, False])
def test_extract_k_bucketed_matches_reference(pruned):
    rng = np.random.default_rng(11)
    nb, bc, k_max = 8, 16, 32
    keys, vals, counts, splitters = _bucket_store(rng, nb, bc)
    total = int(counts.sum())
    spl = splitters if pruned else None
    for k in (0, 1, total // 2, min(total, k_max)):
        got = tops.extract_k_bucketed(
            _t(keys), _t(vals), _t(counts), k, k_max,
            splitters=None if spl is None else _t(spl), backend=CUDA)
        _check_extract(got, keys, vals, counts, k, k_max, spl)


def test_extract_k_bucketed_any_k_max():
    """A k_max that is not a power of two (the reference's Pallas branch
    refuses it): equal to the oracle, and the survivors are the store's
    multiset less the extracted pairs, in their slot order."""
    rng = np.random.default_rng(12)
    nb, bc, k_max = 8, 16, 24
    keys, vals, counts, splitters = _bucket_store(rng, nb, bc)
    total = int(counts.sum())
    for k in (1, total // 2, total):
        got = tops.extract_k_bucketed(_t(keys), _t(vals), _t(counts), k,
                                      k_max, splitters=_t(splitters),
                                      backend=CUDA)
        _check_extract(got, keys, vals, counts, k, k_max, pallas=False)
        keff = min(k, total, k_max)
        nk, nv, nc = (_np(x) for x in got[2:])
        assert nc.sum() == total - keff
        for r in range(nb):
            kept = set(nv[r, :nc[r]].tolist())
            row = [v for v in vals[r, :counts[r]].tolist() if v in kept]
            assert nv[r, :nc[r]].tolist() == row   # slot order kept
            assert np.isinf(nk[r, nc[r]:]).all()
        out = set(_np(got[1])[:keff].tolist())
        assert out.isdisjoint(set(nv[nv >= 0].tolist()))


def test_extract_k_bucketed_lane_major():
    """[3, NB, BCAP] stores with one k per lane, in one call."""
    rng = np.random.default_rng(13)
    nb, bc, k_max = 8, 16, 32
    stores = [_bucket_store(rng, nb, bc) for _ in range(3)]
    keys, vals, counts, splitters = (np.stack(x) for x in zip(*stores))
    k = np.array([0, 9, 40], np.int32)
    got = tops.extract_k_bucketed(_t(keys), _t(vals), _t(counts), _t(k),
                                  k_max, splitters=_t(splitters),
                                  backend=CUDA)
    want = _j_extract_pallas(k_max)(_j(keys), _j(vals), _j(counts), _j(k),
                                    splitters=_j(splitters))
    for i in (0, 2, 3, 4):
        _eq(got[i], want[i], f"leaf {i}")
    for lane in range(3):
        assert _pairs(got[0][lane], got[1][lane]) == _pairs(
            want[0][lane], want[1][lane])
        ek, ev = _j_ref_extract(_j(keys[lane]), _j(vals[lane]),
                                _j(counts[lane]), int(k[lane]), k_max)
        _eq(got[0][lane], ek)
        _eq(got[1][lane], ev)
