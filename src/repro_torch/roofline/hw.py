"""Hardware constants for the roofline model: one NVIDIA H100 SXM5.

Peaks from NVIDIA's H100 Tensor Core GPU data sheet (SXM5 column, dense
rates without sparsity, at the full 700 W power limit): 989 TFLOP/s
BF16 tensor core, 3.35 TB/s HBM3, and NVLink 4 at 900 GB/s total per
card, 450 GB/s in each direction.  A card set below 700 W runs slower
under load: state a share against these peaks with the card's power
limit beside it.

Terms:
    compute    = FLOPs      / PEAK_FLOPS              [per card]
    memory     = HBM bytes  / HBM_BW                  [per card]
    collective = link bytes / ICI_BW (NVLink)         [per card]

The names are the reference roof's (``ICI_BW`` is the card-to-card link
here).  HBM capacity is read from the card at call time
(:func:`hbm_bytes`), not typed in.

``DCN_BW`` is the rate between nodes: one 400 Gb/s ConnectX-7 port a
GPU, 50 GB/s, from NVIDIA's DGX H100 data sheet.  A DGX H100 node holds
eight cards on NVLink, so a 16 x 16 mesh spans 32 nodes: its link term
at ``ICI_BW`` is optimistic, and still a lower bound.  The dry run
weighs a 2 x 16 x 16 mesh's link bytes at ``DCN_BW``.
"""

PEAK_FLOPS = 989e12        # dense BF16 FLOP/s per card
HBM_BW = 3.35e12           # HBM3 bytes/s per card
ICI_BW = 450e9             # NVLink bytes/s per card, one direction
DCN_BW = 50e9              # bytes/s per card between nodes (400 Gb/s)


def hbm_bytes(device=0) -> int:
    """Device memory of the card, from ``torch.cuda`` at call time."""
    import torch
    return int(torch.cuda.get_device_properties(device).total_memory)
