"""The model stack of the port: the architecture config
(``arch_config``), the layers (``layers``, ``attention``, ``moe``,
``mamba2``, ``xlstm``), model assembly and the serving steps' functions
(``transformer``: prefill, chunked prefill, decode, teacher-forcing
forward, ``Model``) and the exchange of parameters and caches with the
JAX package (``interop``).  Training (the loss and its gradients) and
the mesh are not ported yet."""
