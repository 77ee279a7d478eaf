"""K1's and K4's launch plans and K4's digit walk, on the CPU.

``repro_torch.kernels.merge_consume.launch_plan`` and
``repro_torch.kernels.radix_select.launch_plan`` compute in Python what the
CUDA kernels take as dimensions.  K1's plan must cover every output of
every row exactly once, and each CTA's windows, found by the kernel's
co-rank search (emulated here as ``merge_path.cuh`` runs it), must lie
inside both streams and merge to the plain version's rows.  K4's plan must
pick its kernel by the rows' length and count, and size a cooperative
grid no larger than the card holds at once.  A numpy emulation of K4's
digit walk (its rounds, the CTAs' histograms summed, warp 0's scan,
``n_below`` from the histograms) is held against the JAX package's
``radix_select_threshold`` in interpret mode, at the edges its tests pin.
"""

import numpy as np
import pytest
import torch

from repro.kernels.radix_select import radix_select_threshold as j_radix
from repro_torch.kernels import merge_consume, radix_select

#: an H100's SMs and the opt-in shared memory a block may use (less the
#: reserve the wrapper keeps), and the grid kernel's CTAs an SM there
SMS = 132
SMEM = 232_448 - radix_select.SMEM_RESERVE


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def _corank_warp(a, b, d):
    """``merge_path::corank_warp`` in numpy: 32 probes a round, then the
    last 32 positions at once."""
    n, m = len(a), len(b)
    lo, hi = max(0, d - m), min(d, n)

    def take(p):              # the kernel loads only where p < hi
        ok = p < hi
        if hi <= lo:
            return ok
        q = np.minimum(p, hi - 1)
        return ok & (a[q] <= b[d - q - 1])

    lanes = np.arange(32)
    while hi - lo > 32:
        step = (hi - lo + 31) >> 5
        c = int(take(lo + (lanes + 1) * step - 1).sum())
        top = lo + (c + 1) * step - 1
        lo, hi = min(lo + c * step, hi), min(top, hi)
    return lo + int(take(lo + lanes).sum())


def _merge_keys(rng, rows, n, m):
    """Sorted streams with ties across them, both zeros and INF padding."""
    pool = np.array([-3.0, -0.0, 0.0, 1.0, 2.0, 2.5, 7.0, np.inf],
                    np.float32)
    return (np.sort(rng.choice(pool, (rows, n)), -1),
            np.sort(rng.choice(pool, (rows, m)), -1))


#: the phase-6 merges, empty streams, tiles that end inside a row, rows x
#: tiles past 65535, and a batch of long rows
_MERGE_SHAPES = [(1, 131072, 1024), (1, 16384, 4096), (8, 1026, 512),
                 (1, 1048576, 1024), (1, 0, 700), (3, 900, 0), (5, 700, 333),
                 (70000, 3, 2), (1, 1, 1), (1024, 1024, 1024)]


@pytest.mark.parametrize("rows,n,m", _MERGE_SHAPES)
def test_merge_plan_covers_every_output_once(rows, n, m):
    plan = merge_consume.launch_plan(rows, n, m, SMS)
    total = n + m
    assert plan.tile in merge_consume.TILES
    assert plan.grid == rows * plan.tiles <= 2 ** 31 - 1
    assert (plan.tiles - 1) * plan.tile < total <= plan.tiles * plan.tile
    covered = np.zeros(rows, np.int64)
    for b in range(plan.grid):
        row, d0, d1 = plan.cover(b)
        assert d0 == covered[row] and d0 < d1 <= total, (b, row, d0, d1)
        covered[row] = d1
    assert (covered == total).all()
    if rows * total >= 2 * SMS * 512:
        assert plan.grid >= 2 * SMS
    if rows == 70000:
        assert plan.grid > 65535


@pytest.mark.parametrize("rows,n,m", [s for s in _MERGE_SHAPES
                                      if s[0] * (s[1] + s[2]) < 1 << 21])
def test_merge_plan_windows_stay_inside_both_streams(rows, n, m):
    """Each CTA's co-ranks (the kernel's search) give windows inside a and
    b whose merges, tile after tile, are the plain version's rows."""
    rng = np.random.default_rng(rows + n + m)
    ak, bk = _merge_keys(rng, rows, n, m)
    plan = merge_consume.launch_plan(rows, n, m, SMS)
    order = np.zeros((rows, n + m), np.int64)
    for b in range(min(plan.grid, 4000)):
        row, d0, d1 = plan.cover(b)
        i0, i1 = (_corank_warp(ak[row], bk[row], d) for d in (d0, d1))
        j0, j1 = d0 - i0, d1 - i1
        assert 0 <= i0 <= i1 <= n and 0 <= j0 <= j1 <= m, (b, i0, i1, j0, j1)
        i, j = i0, j0
        for q in range(d0, d1):      # the thread merge, ties a-first
            if j >= j1 or (i < i1 and ak[row, i] <= bk[row, j]):
                order[row, q], i = i, i + 1
            else:
                order[row, q], j = n + j, j + 1
    done = min(plan.grid, 4000) // plan.tiles
    if done == 0 or not (n and m):   # the plain version needs both streams
        return
    want = merge_consume.merge_sorted_kvf_plain(
        *(torch.from_numpy(x[:done]) for x in (
            ak, np.arange(n, dtype=np.int32)[None].repeat(rows, 0),
            np.zeros((rows, n), np.int32), bk,
            n + np.arange(m, dtype=np.int32)[None].repeat(rows, 0),
            np.ones((rows, m), np.int32))))
    assert (want[1].numpy() == order[:done]).all()


# ---------------------------------------------------------------------------
# K4: the plan
# ---------------------------------------------------------------------------

def _select_plan(rows, length, smem=SMEM, blocks=1):
    return radix_select.launch_plan(rows, length, SMS, smem, blocks)


@pytest.mark.parametrize("rows,length,kernel", [
    (1024, 1024, "row"), (8, 1024, "row"), (1, 8192, "row"),
    (1, 16384, "row"), (1, 16385, "grid"), (132, 40000, "row"),
    (131, 40000, "grid"), (1, 1 << 20, "grid"), (6, 1 << 20, "grid"),
    (1, 9 << 20, "grid"), (500, 1 << 20, "grid"), (200, 49153, "grid")])
def test_select_plan_picks_the_kernel_by_length(rows, length, kernel):
    plan = _select_plan(rows, length)
    assert plan.kernel == kernel
    assert plan.smem_bytes <= SMEM
    hist = 8 * radix_select.HIST_WORDS
    if kernel == "row":
        assert plan.grid == rows and 128 <= plan.threads <= 1024
        assert plan.threads & (plan.threads - 1) == 0
        assert plan.smem_bytes == hist + 4 * length
        return
    assert plan.threads == radix_select.GRID_THREADS
    assert plan.grid == plan.groups * plan.per_row <= SMS
    assert plan.groups == min(rows, SMS)
    assert plan.chunk % 4 == 0
    spans = plan.chunks()
    assert spans[0][0] == 0 and spans[-1][1] == length
    assert all(a[1] == b[0] < b[1] for a, b in zip(spans, spans[1:]))
    assert plan.staged == (hist + 4 * plan.chunk <= SMEM)
    if rows == 1:
        assert plan.staged == (length < 9 << 20)
    assert plan.smem_bytes == hist + (4 * plan.chunk if plan.staged else 0)


@pytest.mark.parametrize("blocks", [1, 2])
def test_select_plan_grid_fits_the_card(blocks):
    """The cooperative grid never exceeds SMs x the CTAs an SM holds, and
    a row too long for one CTA's shared memory never takes the row
    kernel."""
    for rows in (1, 3, 132, 133, 1000):
        for length in (16385, 40000, 1 << 20, 3 << 21):
            plan = _select_plan(rows, length, blocks=blocks)
            if plan.kernel == "grid":
                assert plan.grid <= SMS * blocks
                assert plan.chunk >= min(radix_select.MIN_CHUNK, length)
    small = 48 * 1024
    plan = _select_plan(200, 12000, smem=small)
    assert plan.kernel == "grid"
    assert _select_plan(200, 11000, smem=small).kernel == "row"


def test_digit_rounds_cover_the_word():
    rounds = radix_select.digit_rounds()
    assert sum(w for _, w in rounds) == 32
    assert rounds[0][0] + rounds[0][1] == 32 and rounds[-1][0] == 0
    assert all(a[0] == b[0] + b[1] for a, b in zip(rounds, rounds[1:]))
    bins = 1 << radix_select.DIGIT_BITS
    assert radix_select.WS_INTS == len(rounds) * bins + 4
    assert radix_select.HIST_WORDS == bins + bins // 32


# ---------------------------------------------------------------------------
# K4: the digit walk against the reference kernel
# ---------------------------------------------------------------------------

def _sortable(keys):
    u = keys.view(np.uint32).astype(np.uint64)
    return np.where(u >> 31 != 0, u ^ 0xFFFFFFFF, u | 0x80000000)


def _from_sortable(u):
    bits = np.uint32(u ^ 0xFFFFFFFF if u < 0x80000000 else u & 0x7FFFFFFF)
    return bits.view(np.float32)


def _pick(hist, rem):
    """Warp 0's scan: lanes own runs of nbins / 32 bins; the lane whose
    run holds the crossing walks it."""
    nbins = len(hist)
    if rem <= 0:
        return 0, 0
    runs = hist.reshape(32, nbins // 32)
    incl = np.cumsum(runs.sum(1))
    if rem > incl[-1]:
        return nbins - 1, int(incl[-1] - hist[-1])
    lane = int(np.argmax(incl >= rem))
    c = int(incl[lane] - runs[lane].sum())
    for q, v in enumerate(runs[lane]):
        if c + v >= rem:
            return lane * (nbins // 32) + q, c
        c += int(v)
    raise AssertionError("no crossing")


def _digit_walk(keys, k, ctas=3):
    """K4's rounds on one stream split over ``ctas`` CTAs: each round the
    CTAs' histograms of the matching keys' digit, summed; (tau,
    n_below)."""
    u = _sortable(keys)
    prefix, rem = 0, int(k)
    for r, (shift, width) in enumerate(radix_select.digit_rounds()):
        above = 0 if r == 0 else (0xFFFFFFFF << (shift + width)) & 0xFFFFFFFF
        hist = np.zeros(1 << width, np.int64)
        for chunk in np.array_split(u, ctas):
            hit = chunk[(chunk & above) == prefix]
            hist += np.bincount(((hit >> shift) & ((1 << width) - 1))
                                .astype(np.int64), minlength=1 << width)
        digit, below = _pick(hist, rem)
        prefix |= digit << shift
        rem -= below
    if k <= 0:
        return np.float32(-np.inf), 0
    return _from_sortable(prefix), int(k) - rem


def _walk_eq(keys, k, msg):
    tau, n_below = _digit_walk(keys, k)
    wt, wn = j_radix(keys, k)
    assert np.asarray(tau).view(np.int32) == np.asarray(wt).view(np.int32), \
        (msg, k, float(tau), float(wt))
    assert n_below == int(wn), (msg, k, n_below, int(wn))


def _edge_streams(length):
    rng = np.random.default_rng(length + 1)
    keys = rng.uniform(-5, 5, length).astype(np.float32)
    neg = -np.abs(rng.uniform(0.5, 100, length)).astype(np.float32)
    half = np.full(length, np.inf, np.float32)
    half[: length // 2] = rng.uniform(0, 10, length // 2)
    zeros = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, np.inf], np.float32),
                       length)
    return {
        "k=0": (keys, [0]),
        "all INF": (np.full(length, np.inf, np.float32),
                    [1, length // 2, length]),
        "negative": (neg, [1, 7, length]),
        "signed zeros": (zeros, list(range(0, length + 1, 13))),
        "k past the finite count": (half, [length // 2 + 1, length]),
        "k past the stream": (keys, [length + 1, length + 3]),
        "random": (keys, [1, length // 3, length // 2, length - 1]),
    }


@pytest.mark.parametrize("length", [64, 1024])
@pytest.mark.parametrize("case", ["k=0", "all INF", "negative",
                                  "signed zeros", "k past the finite count",
                                  "k past the stream", "random"])
def test_digit_walk_matches_reference(case, length):
    keys, ks = _edge_streams(length)[case]
    for k in ks:
        _walk_eq(keys, k, f"{case} L={length}")


@pytest.mark.parametrize("ctas", [1, 5])
def test_digit_walk_matches_plain_version_on_ties(ctas):
    """Duplicate-heavy streams with both zeros, split over one CTA (the
    row kernel) or several (the grid kernel), against the port's plain
    version (the reference's order: -0.0 below 0.0)."""
    rng = np.random.default_rng(ctas)
    keys = rng.choice(np.array([-2.0, -0.0, 0.0, 3.0, 3.5, np.inf],
                               np.float32), (4, 500))
    ks = np.array([0, 1, 250, 501], np.int32)
    tau, n_below = radix_select.radix_select_threshold_plain(
        torch.from_numpy(keys), torch.from_numpy(ks))
    for r in range(4):
        t, nb = _digit_walk(keys[r], int(ks[r]), ctas)
        assert np.float32(t).view(np.int32) == tau[r].view(torch.int32)
        assert nb == int(n_below[r])
