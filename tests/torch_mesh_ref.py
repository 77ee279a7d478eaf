"""The JAX package's mesh runs, for the port's mesh parity tests
(``tests/test_torch_mesh.py``): run as a script in its own process with
eight forced host devices (the device count locks at jax's first init,
as ``tests/test_multidev.py`` shows), it writes one npz per check into
the directory given:

* ``moe.npz``: ``moe_apply`` under ``use_mesh`` on a (2, 4) mesh and
  ``_moe_local``, at ``tests/multidev_checks.py``'s MoE config;
* ``train_<name>.npz``: one jitted sharded train step on a (2, 4) mesh
  (FSDP, ZeRO-1, float32, warmup 0): reduced gemma-2b at 2 layers and
  vocab 512, n_micro 2, with AdamW (``dense``) and AdamW8 (``dense8``),
  and reduced moonshot-v1-16b-a3b (untied, so one-hot lookups, and
  ``moe_apply_dist``; ``moe``); the state before and the gathered state
  after, the batch and the metrics;
* ``decode.npz``: a sharded prefill and two decode steps (rows at
  different positions) of reduced gemma-2b (2 layers, vocab 512,
  float32) on a (2, 4) mesh with ``params_shardings`` /
  ``cache_shardings``, the caches gathered after each;
* ``compress.npz``: two ``compressed_psum`` steps under ``shard_map``
  over the ``pod`` axis of a (2, 2, 2) mesh.

Trees are saved flat, each leaf under its ``jax.tree_util.keystr`` in
``jax.tree.leaves`` order, with bfloat16 as its uint16 view.  Imported
(by the tests, for its constants and ``train_batch``) it touches no JAX
state: the eight devices are forced only when it runs as a script.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

#: the train checks: (arch, changes to reduced_config, opt_8bit)
TRAIN = {"dense": ("gemma-2b", dict(n_layers=2, vocab=512), False),
         "dense8": ("gemma-2b", dict(n_layers=2, vocab=512), True),
         "moe": ("moonshot-v1-16b-a3b", {}, False)}
TRAIN_KW = dict(n_micro=2, fsdp=True, zero1=True, peak_lr=1e-3, warmup=0,
                total_steps=10)
MOE_CFG = dict(n_experts=8, top_k=2, capacity_factor=8.0)
DECODE_B, DECODE_PROMPT, DECODE_SMAX = 8, 16, 32


def flat(tree, prefix: str) -> dict:
    import jax
    import jax.numpy as jnp
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        x = np.asarray(leaf)
        if x.dtype == jnp.bfloat16:
            x = x.view(np.uint16)
        out[prefix + jax.tree_util.keystr(path)] = x
    return out


def train_batch(vocab: int, seed: int = 1):
    """tokens [8, 32], next-token labels with the last position and the
    first three of rows 0 and 5 masked (each microbatch's valid count
    differs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (8, 32)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    labels[5, :3] = -1
    return {"tokens": toks, "labels": labels}


def check_moe(out: Path):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.dist.sharding import make_mesh, use_mesh
    from repro.models import moe
    cfg = dataclasses.replace(reduced_config("qwen3-moe-235b-a22b"),
                              dtype="float32", **MOE_CFG)
    mesh = make_mesh((2, 4), ("data", "model"))
    params = moe.moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model),
                          jnp.float32) * 0.1
    y_local, aux_local = moe._moe_local(params, cfg, x)
    with use_mesh(mesh):
        y_dist, aux_dist = jax.jit(
            lambda p, xx: moe.moe_apply(p, cfg, xx))(params, x)
    np.savez(out / "moe.npz", x=np.asarray(x), y_local=np.asarray(y_local),
             aux_local=np.asarray(aux_local), y_dist=np.asarray(y_dist),
             aux_dist=np.asarray(aux_dist), **flat(params, "params"))


def check_train(out: Path, name: str):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.dist.sharding import make_mesh, use_mesh
    from repro.launch.train import (TrainConfig, batch_specs,
                                    init_train_state, make_train_step,
                                    state_shardings)
    arch, changes, opt8 = TRAIN[name]
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **changes)
    tcfg = TrainConfig(opt_8bit=opt8, **TRAIN_KW)
    mesh = make_mesh((2, 4), ("data", "model"))
    with use_mesh(mesh):
        state = init_train_state(cfg, jax.random.PRNGKey(0), tcfg)
        before = flat(state, "before")
        st_sh = state_shardings(cfg, tcfg, mesh, jax.eval_shape(
            lambda: state))
        state = jax.tree.map(jax.device_put, state, st_sh)
        step = jax.jit(make_train_step(cfg, tcfg, mesh),
                       in_shardings=(st_sh, batch_specs(cfg, mesh)),
                       donate_argnums=(0,))
        batch = train_batch(cfg.vocab)
        state, metrics = step(state, jax.device_put(
            {k: jnp.asarray(v) for k, v in batch.items()},
            batch_specs(cfg, mesh)))
        np.savez(out / f"train_{name}.npz", **before,
                 **flat(jax.device_get(state), "after"), **batch,
                 **{f"metric_{k}": np.asarray(v)
                    for k, v in metrics.items()})


def check_decode(out: Path):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.dist.sharding import make_mesh, use_mesh
    from repro.launch.serve import cache_shardings, params_shardings
    from repro.models import transformer as tf
    cfg = dataclasses.replace(reduced_config("gemma-2b"), n_layers=2,
                              vocab=512, dtype="float32")
    mesh = make_mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (DECODE_B, DECODE_PROMPT)).astype(
        np.int32)
    steps = rng.integers(0, cfg.vocab, (2, DECODE_B, 1)).astype(np.int32)
    res = {"tokens": toks, "steps": steps}
    with use_mesh(mesh):
        params = tf.init_params(cfg, jax.random.PRNGKey(0))
        caches = tf.init_decode_caches(cfg, DECODE_B, DECODE_SMAX)
        res.update(flat(params, "params"))
        p_sh = params_shardings(cfg, mesh, jax.eval_shape(lambda: params))
        c_sh = cache_shardings(cfg, mesh, jax.eval_shape(lambda: caches))
        params = jax.tree.map(jax.device_put, params, p_sh)
        caches = jax.tree.map(jax.device_put, caches, c_sh)
        logits, caches = jax.jit(
            lambda p, c, t: tf.prefill(cfg, p, t, c))(params, caches,
                                                      jnp.asarray(toks))
        res["logits_prefill"] = np.asarray(logits)
        res.update(flat(jax.device_get(caches), "caches_prefill"))
        dec = jax.jit(lambda p, c, t, q: tf.decode_step(cfg, p, t, c, q))
        for i in range(2):
            pos = np.full((DECODE_B,), DECODE_PROMPT + i, np.int32)
            pos[1::2] -= 5      # odd rows rewrite earlier positions
            res[f"pos{i}"] = pos
            logits, caches = dec(params, caches, jnp.asarray(steps[i]),
                                 jnp.asarray(pos))
            res[f"logits_decode{i}"] = np.asarray(logits)
            res.update(flat(jax.device_get(caches), f"caches_decode{i}"))
    np.savez(out / "decode.npz", **res)


def check_compress(out: Path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.sharding import make_mesh, shard_map
    from repro.optim.compress import compress_init, compressed_psum
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    rng = np.random.default_rng(4)
    shapes = {"a": (2, 64, 16), "b": (2, 300), "c": (2, 8, 8, 4)}
    res = {}
    grads = [{k: jnp.asarray(rng.standard_normal(s).astype(np.float32)
                             * (10.0 ** -i)) for i, (k, s) in
              enumerate(sorted(shapes.items()))} for _ in range(2)]
    state = compress_init(grads[0])
    specs = {k: P("pod") for k in shapes}

    def body(g, e):
        red, st = compressed_psum(g, type(state)(error=e), "pod")
        return red, st.error

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, specs),
                           out_specs=(specs, specs)))
    err = state.error
    for step, g in enumerate(grads):
        res.update(flat(g, f"g{step}"))
        res.update(flat(err, f"e{step}"))
        red, err = fn(g, err)
        res.update(flat(red, f"red{step}"))
    res.update(flat(err, "e2"))
    np.savez(out / "compress.npz", **res)


def main(out: str) -> None:
    import jax
    if len(jax.devices()) != 8:
        sys.exit(f"host device count is {len(jax.devices())}, wanted 8")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    check_moe(out)
    for name in TRAIN:
        check_train(out, name)
    check_decode(out)
    check_compress(out)
    print("MESH REF OK")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    main(sys.argv[1])
