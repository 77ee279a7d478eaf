"""The port's plain primitives ("torch" backend) against the JAX
package's jnp branches.

Each case of tests/test_kernels.py that pins a jnp-branch primitive runs
here through both packages on the same numpy inputs; results must be
equal bit for bit, dtypes included (nothing here does float arithmetic).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.radix_select import _to_sortable_u32 as j_u32
from repro_torch.kernels import ops as tops

JNP = jops.resolve_backend("jnp")
TORCH = tops.resolve_backend("torch")


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_sortable_u32_map_matches():
    x = np.array([-np.inf, -2.5, -0.0, 0.0, 1e-38, 3.0, 1e30, np.inf],
                 np.float32)
    got = tops._to_sortable_u32(_t(x)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(j_u32(jnp.asarray(x))))


@pytest.mark.parametrize("n", [1, 2, 7, 300, 4097])
def test_float_minima_match_reference_on_signed_zeros(n):
    """The reference's min and minimum order -0.0 below 0.0; compared as
    bits, since -0.0 == 0.0 as floats."""
    rng = np.random.default_rng(n)
    pool = np.array([0.0, -0.0, 0.0, 3.0, np.inf], np.float32)
    x = rng.choice(pool, (6, n))
    y = rng.choice(pool, (6, n))
    got = tops.amin_f32(_t(x), -1).numpy()
    want = np.asarray(jnp.min(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = tops.amin_f32(_t(x.reshape(2, 3, n)), (-2, -1)).numpy()
    want = np.asarray(jnp.min(jnp.asarray(x.reshape(2, 3, n)), axis=(-2, -1)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got = tops.minimum_f32(_t(x), _t(y)).numpy()
    want = np.asarray(jnp.minimum(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_searchsorted_last_matches_reference():
    """tests/test_kernels.py's searchsorted sweep: sides, ties, INF
    padding, int dtypes and leading dims, across both branches."""
    rng = np.random.default_rng(12)
    branches = set()
    for trial in range(24):
        n = int(rng.integers(1, 400))
        m = int(rng.integers(1, 300))
        lead = () if trial % 3 == 0 else (int(rng.integers(1, 5)),)
        if trial % 4 == 0:
            a = np.sort(rng.integers(0, 25, lead + (n,)).astype(np.int32),
                        axis=-1)
            v = rng.integers(-3, 30, lead + (m,)).astype(np.int32)
        else:
            pool = np.array([0.0, 0.5, 1.5, 2.5, np.inf], np.float32)
            a = np.sort(rng.choice(pool, lead + (n,)), axis=-1)
            v = rng.choice(np.append(pool, [-1.0, 3.0]), lead + (m,))
        branches.add(int(np.prod(lead)) * n * m <= (1 << 17))
        for side in ("left", "right"):
            want = jops.searchsorted_last(jnp.asarray(a), jnp.asarray(v),
                                          side=side)
            _eq(tops.searchsorted_last(_t(a), _t(v), side=side), want,
                f"trial {trial} {side}")
            # the two branches agree wherever either can run
            _eq(tops._searchsorted_compare_all(_t(a), _t(v), side=side),
                want, f"compare-all trial {trial} {side}")
    assert branches == {True, False}


@pytest.mark.parametrize("shape", [(6, 257), (3, 8), (1,), (4, 2, 33)])
def test_argsort_matches_reference(shape):
    """Duplicates, ±INF and -0.0 (which orders before 0.0 on the u32 map)."""
    rng = np.random.default_rng(3)
    keys = rng.choice([0.0, -0.0, 1.5, 2.5, np.inf, -np.inf, -4.0, 1e30],
                      shape).astype(np.float32)
    _eq(tops.argsort_f32_last(_t(keys)),
        jops.argsort_f32_last(jnp.asarray(keys)))


def test_sort_kvf_matches_reference():
    rng = np.random.default_rng(4)
    keys = rng.choice([0.0, -0.0, 1.0, np.inf, 7.5], (3, 40)).astype(
        np.float32)
    vals = rng.integers(-5, 1 << 30, (3, 40)).astype(np.int32)
    flags = rng.integers(0, 2, (3, 40)).astype(np.int32)
    got = tops.sort_kvf(_t(keys), _t(vals), _t(flags), backend=TORCH)
    want = jops.sort_kvf(jnp.asarray(keys), jnp.asarray(vals),
                         jnp.asarray(flags), backend=JNP)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_merge_sorted_matches_reference(lead):
    """Ties a-first, INF padding, payloads past 2**24, odd total length."""
    rng = np.random.default_rng(5)
    pool = np.array([0.0, -0.0, 1.0, 2.0, 2.0, 9.0], np.float32)
    n, m = 37, 20
    ak = np.sort(rng.choice(pool, lead + (n,)), -1)
    bk = np.sort(rng.choice(pool, lead + (m,)), -1)
    ak[..., -5:] = np.inf
    bk[..., -3:] = np.inf
    av = rng.integers(1 << 24, 1 << 30, lead + (n,)).astype(np.int32)
    bv = rng.integers(-100, 0, lead + (m,)).astype(np.int32)
    af = np.zeros(lead + (n,), np.int32)
    bf = np.ones(lead + (m,), np.int32)
    got = tops.merge_sorted(*(_t(x) for x in (ak, av, af, bk, bv, bf)),
                            backend=TORCH)
    want = jops.merge_sorted(*(jnp.asarray(x)
                               for x in (ak, av, af, bk, bv, bf)),
                             backend=JNP)
    for g, w in zip(got, want):
        _eq(g, w)


def test_sorted_runs_gather_lane_major_matches_reference():
    rng = np.random.default_rng(8)
    L, nb, bc = 3, 4, 8
    keys = np.full((L, nb, bc), np.inf, np.float32)
    vals = np.full((L, nb, bc), -1, np.int32)
    counts = rng.integers(0, bc + 1, (L, nb)).astype(np.int32)
    for lane in range(L):
        base = 0.0
        for b in range(nb):
            c = counts[lane, b]
            # unsorted rows: the gather sorts each one itself
            keys[lane, b, :c] = rng.uniform(base, base + 10, c)
            vals[lane, b, :c] = rng.integers(0, 99, c)
            base += 10.0
    got = tops.sorted_runs_gather(_t(keys), _t(vals), _t(counts), 16)
    want = jops.sorted_runs_gather(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(counts), 16)
    for g, w in zip(got, want):
        _eq(g, w)
    for lane in range(L):
        one = tops.sorted_runs_gather(_t(keys[lane]), _t(vals[lane]),
                                      _t(counts[lane]), 16)
        for batched, single in zip(got, one):
            _eq(batched[lane], single.numpy())


def _bucket_store(rng, nb, bc):
    splitters = np.full(nb, np.inf, np.float32)
    edges = np.sort(rng.uniform(0, 100, nb - 1))
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
    return keys, vals, counts, splitters


def test_extract_k_bucketed_matches_reference():
    """tests/test_kernels.py's extraction case (jnp branch), every k."""
    rng = np.random.default_rng(11)
    nb, bc, k_max = 8, 16, 32
    keys, vals, counts, splitters = _bucket_store(rng, nb, bc)
    total = int(counts.sum())
    for k in (0, 1, total // 2, min(total, k_max), total + 5):
        got = tops.extract_k_bucketed(_t(keys), _t(vals), _t(counts), k,
                                      k_max, backend=TORCH)
        want = jops.extract_k_bucketed(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(counts), k,
            k_max, splitters=jnp.asarray(splitters), backend=JNP)
        for g, w in zip(got, want):
            _eq(g, w, f"k={k}")


def test_extract_k_bucketed_lane_major_matches_reference():
    rng = np.random.default_rng(12)
    nb, bc, k_max = 4, 8, 16
    stores = [_bucket_store(rng, nb, bc) for _ in range(3)]
    keys, vals, counts, _ = (np.stack(x) for x in zip(*stores))
    k = np.array([0, 5, 40], np.int32)
    got = tops.extract_k_bucketed(_t(keys), _t(vals), _t(counts), _t(k),
                                  k_max, backend=TORCH)
    want = jops.extract_k_bucketed(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(counts), jnp.asarray(k),
                                   k_max, backend=JNP)
    for g, w in zip(got, want):
        _eq(g, w)
