"""The model stack of the port: the architecture config
(``arch_config``), the layers (``layers``, ``attention``, ``moe``,
``mamba2``, ``xlstm``), model assembly and the serving steps' functions
(``transformer``: prefill, chunked prefill, decode, teacher-forcing
forward, ``Model``) and the exchange of parameters and caches with the
JAX package (``interop``, which also places a numpy tree on a mesh).
Training's loss is ``transformer.loss_fn``; under ``dist.use_mesh`` an
untied table is looked up one-hot and an MoE layer runs
expert-parallel."""
