"""Trip counts of the model stack's loops, which the dry run may cap.

Eager PyTorch runs the reference's ``lax.scan`` loops in Python: the
pattern groups, the encoder's layers, the chunked prefill's chunks,
attention's query and key chunks, the mLSTM chunks, the sLSTM steps,
the SSD chunks and the train step's microbatches.  Each such loop runs
over ``trips(site, n)``.  Outside ``capped`` that is ``range(n)``: the
loop runs as written, and no number changes.

The dry run (``launch.dryrun``) runs a step at its full shapes with
each loop capped at a few iterations, and recovers what the full step
counts from how the counts grow with the caps: the counterpart of the
reference's ``hlo_stats``, which counts a while loop's body once and
multiplies it by the trip count it reads off the loop's condition.
A loop that collects one result an iteration fills the iterations it
skipped with its last result, detached (``pad``), so that what follows
the loop sees the full loop's shapes and the backward runs through the
iterations run alone.

Under ``capped`` each loop also marks where the trace is in the loop
nest (``point``): a stretch (the last iteration start or loop end, of
which loop, itself placed by where it began) and the ops since.  The
same place recurs in every iteration, whatever the caps, so the dry run
can fit the live bytes at each place apart (``roofline.trace_stats``).

A mesh train step's data rows run over ``each_row(...)``: every row as
written outside ``capped``.  Under it, each row starts the same stretch
and a place also names the row it lies in (``point`` returns (place,
row)), so that one row's places are another's with the row changed; the
dry run may run only some rows (``capped(..., rows=...)``) and predict
the others from them (``launch.dryrun.RowPlan``).  Inside a row, each
block of a copy between positions starts the same stretch too
(``each_copy``).  ``now()`` is the row running.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Set, Tuple

#: (site, full trip count) -> cap, while the dry run caps loops
_CAPS: Optional[Dict[Tuple[str, int], int]] = None
#: the indices of the data rows to run under ``capped``, or None: all
_ROWS: Optional[Set[int]] = None
#: (site, n) -> the cap of a loop not in _CAPS, or None: as written
_CORNER = None
#: the (site, full trip count) pairs met under ``capped``
_SEEN: Optional[Set[Tuple[str, int]]] = None

#: the least cap at which a loop's iterations are alike enough for the
#: dry run's fit: the first and last few iterations of a loop differ
#: from the rest in the backward (which grads accumulate, which saved
#: tensors are freed first), the recurrences' by one or two more (the
#: dry run's grid is ``first``, ``first`` + 1, its check point
#: ``first`` + 2; a cap below these fails the check at the reduced
#: configs; the mLSTM key chunks' at xlstm-350m's ``train_4k``, where
#: 18 peak places grow faster with the key chunks up to the 7th: from the
#: 5th with two sequences a data row's piece (16 x 16), the 7th with one
#: (2 x 16 x 16))
FIRST = {"ssd.chunks": 5, "slstm.steps": 4, "mlstm.q": 4, "mlstm.k": 7}
FIRST_DEFAULT = 3


def first(site: str) -> int:
    return FIRST.get(site, FIRST_DEFAULT)


def small(site: str) -> int:
    """A loop at ``site`` of this many iterations or fewer runs as
    written: its check point would not be short of it."""
    return first(site) + 2

#: [stretch, autograd node serial, its tag, ops since the stretch or
#: node began, the forward's stretch when the backward began, the data
#: row the stretch lies in (None: none, or a node named by its op's name,
#: which every row's backward shares), the forward's row when the
#: backward began]
_AT = [0, None, None, 0, None, None, None]
#: [the data row running (its index), or None]
_NOW = [None]


def _id(key: tuple) -> int:
    """A place in the loop nest as an integer: the same in every trace
    of a process and of the processes it forks (a hash)."""
    return hash(key)


#: the place of a trace's arguments, live from its start
ARGUMENTS = (_id(("arguments",)), None)


def trips(site: str, n: int):
    """The iterations to run of a loop of ``n`` at ``site``: ``range(n)``,
    unless the dry run caps the loop (``capped``)."""
    if _CAPS is None:
        return range(n)
    _SEEN.add((site, n))
    cap = _CAPS.get((site, n))
    if cap is None and _CORNER is not None:
        cap = _CORNER(site, n)
    return _marked(site, n, n if cap is None else min(n, cap))


def _marked(site: str, n: int, m: int):
    loop = _id((site, n, _AT[0], _AT[2], _AT[3]))
    for i in range(m):
        _AT[0], _AT[3] = _id(("iteration", loop)), 0
        yield i
    _AT[0], _AT[3] = _id(("end", loop)), 0


def each_row(items):
    """The data rows of a mesh step to run (each with an ``index``), in
    order: ``items`` as given, unless the dry run caps loops
    (``capped``): then each row starts the same stretch of the loop nest
    in the row's own name, and only the rows ``capped``'s ``rows`` names
    run."""
    if _CAPS is None:
        return items
    return _marked_rows(items)


def _marked_rows(items):
    loop = _id(("rows", _AT[0], _AT[2], _AT[3]))
    for item in items:
        if _ROWS is not None and item.index not in _ROWS:
            continue
        _AT[0], _AT[3], _AT[5] = _id(("row", loop)), 0, item.index
        _NOW[0] = item.index
        yield item
    _AT[0], _AT[3], _AT[5] = _id(("end", loop)), 0, None
    _NOW[0] = None


def each_copy(items):
    """The blocks a copy between positions walks (``Sharded.read``'s,
    the ZeRO-1 scatter's), in order: ``items`` as given, unless a data
    row runs under ``capped`` (``each_row``): then each block starts the
    same stretch of the loop nest, so that a row's places do not depend
    on where its own position falls among them (a copy onto the device
    it is on dispatches nothing)."""
    if _NOW[0] is None:
        return items
    return _marked_copies(items)


def _marked_copies(items):
    loop = _id(("copies", _AT[0], _AT[2], _AT[3]))
    for item in items:
        _AT[0], _AT[3] = _id(("copy", loop)), 0
        yield item
    _AT[0], _AT[3] = _id(("end", loop)), 0


def now():
    """The index of the data row running under ``capped``, or None."""
    return _NOW[0]


def point(serial, tag) -> tuple:
    """The place of the op about to run: (an integer for the stretch,
    ``tag`` and the ops since the stretch or the autograd node ``serial``
    began; the data row the stretch lies in, or None).  ``tag`` names
    the backward's node by the place of the op that made it (None in the
    forward), or by its own name where no op placed it.  Each node of
    the backward starts a stretch of its own (a loop it runs again, under
    remat, is placed from there) in its tag's row, and the forward
    resumes in a stretch after its backward."""
    at = _AT
    if serial != at[1]:
        if at[1] is None:
            at[4], at[6] = at[0], at[5]
        if serial is None:
            at[0], at[5] = _id(("resumed", at[4])), at[6]
        else:
            tag, at[5] = (tag, None) if isinstance(tag, str) else tag
            at[0] = _id(("node", tag))
        at[1], at[2], at[3] = serial, tag, 0
    at[3] += 1
    return _id((at[0], at[2], at[3])), at[5]


def pad(xs: list, n: int) -> list:
    """``xs`` (the results of a loop's iterations run) filled to ``n``
    with its last entry, detached, for a loop that ``trips`` cut
    short."""
    if len(xs) == n:
        return xs
    return xs + [xs[-1].detach()] * (n - len(xs))


@contextlib.contextmanager
def capped(caps: Dict[Tuple[str, int], int],
           corner: Optional[Callable[[str, int], Optional[int]]] = None,
           rows: Optional[Set[int]] = None):
    """Run each loop ``(site, n)`` in ``caps`` for at most its cap, and
    every other loop for at most ``corner(site, n)`` (None: as
    written); a mesh step's data rows, only those whose index is in
    ``rows`` (None: every one).  Yields the set of (site, n) pairs the
    extent meets."""
    global _CAPS, _CORNER, _SEEN, _ROWS
    prev = (_CAPS, _CORNER, _SEEN, _ROWS, list(_AT), list(_NOW))
    _CAPS, _CORNER, _SEEN = dict(caps), corner, set()
    _ROWS = None if rows is None else set(rows)
    _AT[:] = [_id(("start",)), None, None, 0, None, None, None]
    _NOW[0] = None
    try:
        yield _SEEN
    finally:
        _CAPS, _CORNER, _SEEN, _ROWS = prev[:4]
        _AT[:], _NOW[:] = prev[4], prev[5]


def active() -> bool:
    return _CAPS is not None


__all__ = ["ARGUMENTS", "FIRST", "active", "capped", "each_copy", "each_row",
           "first", "now", "pad", "point", "small", "trips"]
