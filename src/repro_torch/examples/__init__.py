"""Runnable examples of the port, one module each (``python -m
repro_torch.examples.<name>``, on the card by default):

* ``event_sim`` — a discrete-event simulation on the pqe tick;
* ``quickstart`` — the engine factory, the kernel backend, and the
  rank-error meter;
* ``serve_requests`` — the request engine on one position, then on a
  mesh of positions with a scheduled kill;
* ``dev_check_pq`` — seeded random drives of the pqe tick against the
  heapq oracle.

Each module's ``main(device=...)`` prints the lines of the JAX package's
script of the same name and returns its numbers as a dict.
"""
