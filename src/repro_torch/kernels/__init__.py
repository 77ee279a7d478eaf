"""Kernels of the PyTorch port and their plain versions.

* ops.py           — the kernel ops (batched search, sort, merge, select,
                     extract) with a resolved backend: "torch", the plain
                     twins of the reference's jnp branches, or "cuda", the
                     compositions through the kernels below.
* ref.py           — plain oracles, the twin of the reference's ref.py.
* bitonic.py       — K2, the stable row co-sort (csrc/bitonic.cu).
* merge_consume.py — K1, the rank merge (csrc/merge_consume.cu).
* radix_select.py  — K4, the radix threshold select (csrc/radix_select.cu).
* lane_tick.py     — K3, the lane-tick wrapper (csrc/lane_tick.cu);
                     imported lazily by core/pqueue.py and not re-exported
                     here, it depends on repro_torch.core.
* build.py         — nvcc build + ctypes load of csrc/*.cu into build/.

Each kernel wrapper launches its hand-written CUDA kernel on a CUDA
tensor and takes its plain version on a CPU tensor.
"""

from repro_torch.kernels.ops import (CUDA, TORCH, KernelBackend,
                                     argsort_f32_last, extract_k_bucketed,
                                     merge_sorted, resolve_backend,
                                     searchsorted_last, select_k_smallest,
                                     select_threshold, sort_kvf,
                                     sorted_runs_gather)

__all__ = ["CUDA", "TORCH", "KernelBackend", "argsort_f32_last",
           "extract_k_bucketed", "merge_sorted", "resolve_backend",
           "searchsorted_last", "select_k_smallest", "select_threshold",
           "sort_kvf", "sorted_runs_gather"]
