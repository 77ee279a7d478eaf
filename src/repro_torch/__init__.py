"""PyTorch + CUDA port of APEX-Q, the adaptive priority queue with
elimination and combining (Calciu, Mendes & Herlihy 2014).

The JAX package ``repro`` beside it is the reference; this package
imports neither it nor JAX.  See README.md ("The PyTorch port").
"""

__version__ = "0.1.0"
