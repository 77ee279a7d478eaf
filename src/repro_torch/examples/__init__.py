"""Runnable examples of the port, one module each (``python -m
repro_torch.examples.<name>``, on the card by default):

* ``event_sim`` — a discrete-event simulation on the pqe tick;
* ``quickstart`` — the engine factory, the kernel backend, and the
  rank-error meter;
* ``serve_requests`` — the request engine on one position, then on a
  mesh of positions with a scheduled kill;
* ``dev_check_pq`` — seeded random drives of the pqe tick against the
  heapq oracle;
* ``dev_check_dist`` — the mesh queue at D=8 x l=2 against the
  single-device sharded queue and a multiset mirror;
* ``train_lm`` — a ~100M LM trained on the synthetic stream, each step's
  group drawn from the priority sampler, with checkpoints;
* ``dev_check_models`` — every arch's reduced config through the loss,
  its gradient, prefill and decode;
* ``dryrun_sweep`` — every (arch × shape × mesh) cell of the dry run
  (``launch.dryrun``), a subprocess each (it traces, so it runs no
  ``main(device=...)``).

Each module's ``main(device=...)`` prints the lines of the JAX package's
script of the same name and returns its numbers as a dict.
"""
