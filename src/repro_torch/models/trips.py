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
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Set, Tuple

#: (site, full trip count) -> cap, while the dry run caps loops
_CAPS: Optional[Dict[Tuple[str, int], int]] = None
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
#: configs)
FIRST = {"ssd.chunks": 5, "slstm.steps": 4, "mlstm.q": 4, "mlstm.k": 4}
FIRST_DEFAULT = 3


def first(site: str) -> int:
    return FIRST.get(site, FIRST_DEFAULT)


def small(site: str) -> int:
    """A loop at ``site`` of this many iterations or fewer runs as
    written: its check point would not be short of it."""
    return first(site) + 2

#: [stretch, autograd node serial, its tag, ops since the stretch or
#: node began, the forward's stretch when the backward began]
_AT = [0, None, None, 0, None]


def _id(key: tuple) -> int:
    """A place in the loop nest as an integer: the same in every trace
    of a process and of the processes it forks (a hash)."""
    return hash(key)


#: the place of a trace's arguments, live from its start
ARGUMENTS = _id(("arguments",))


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


def point(serial, tag) -> int:
    """The place of the op about to run, as an integer: (stretch,
    ``tag``, ops since the stretch or the autograd node ``serial``
    began).  ``tag`` names the backward's node by the place of the op
    that made it (None in the forward).  Each node of the backward
    starts a stretch of its own (a loop it runs again, under remat, is
    placed from there), and the forward resumes in a stretch after its
    backward."""
    at = _AT
    if serial != at[1]:
        if at[1] is None:
            at[4] = at[0]
        at[0] = (_id(("resumed", at[4])) if serial is None
                 else _id(("node", tag)))
        at[1], at[2], at[3] = serial, tag, 0
    at[3] += 1
    return _id((at[0], tag, at[3]))


def pad(xs: list, n: int) -> list:
    """``xs`` (the results of a loop's iterations run) filled to ``n``
    with its last entry, detached, for a loop that ``trips`` cut
    short."""
    if len(xs) == n:
        return xs
    return xs + [xs[-1].detach()] * (n - len(xs))


@contextlib.contextmanager
def capped(caps: Dict[Tuple[str, int], int],
           corner: Optional[Callable[[str, int], Optional[int]]] = None):
    """Run each loop ``(site, n)`` in ``caps`` for at most its cap, and
    every other loop for at most ``corner(site, n)`` (None: as
    written).  Yields the set of (site, n) pairs the extent meets."""
    global _CAPS, _CORNER, _SEEN
    prev = (_CAPS, _CORNER, _SEEN, list(_AT))
    _CAPS, _CORNER, _SEEN = dict(caps), corner, set()
    _AT[:] = [_id(("start",)), None, None, 0, None]
    try:
        yield _SEEN
    finally:
        _CAPS, _CORNER, _SEEN = prev[:3]
        _AT[:] = prev[3]


def active() -> bool:
    return _CAPS is not None


__all__ = ["ARGUMENTS", "FIRST", "active", "capped", "first", "pad",
           "point", "small", "trips"]
