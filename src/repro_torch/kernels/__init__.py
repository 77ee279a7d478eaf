"""Kernels of the PyTorch port and their plain versions.

* ops.py       — plain PyTorch twins of the reference's batched search,
                 sort, merge and extract primitives.
* lane_tick.py — the lane-tick wrapper (hand-written CUDA kernel on the
                 card, its plain version on the CPU); imported lazily by
                 core/pqueue.py and not re-exported here, it depends on
                 repro_torch.core.
* build.py     — nvcc build + ctypes load of csrc/*.cu into build/.
"""

from repro_torch.kernels.ops import (argsort_f32_last, extract_k_bucketed,
                                     merge_sorted, searchsorted_last,
                                     sort_kvf, sorted_runs_gather)

__all__ = ["argsort_f32_last", "extract_k_bucketed", "merge_sorted",
           "searchsorted_last", "sort_kvf", "sorted_runs_gather"]
