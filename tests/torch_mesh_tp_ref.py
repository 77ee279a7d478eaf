"""The JAX package's serving steps on a (2, 4) mesh, for the port's
tensor-parallel serving tests (``tests/test_torch_mesh_tp.py``): run as
a script in its own process with eight forced host devices, it writes
``serve_<arch>.npz`` into the directory given for each arch of
``ARCHS``: a prefill and two decode steps (rows at different positions)
of the reduced config in float32 (vocab 512), jitted with the parameters
and caches placed by ``params_shardings`` / ``cache_shardings``, the
caches gathered after each step (as ``tests/torch_mesh_ref.py``'s
``decode.npz`` holds gemma-2b).

Imported (by the tests, for its constants) it touches no JAX state.
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

ARCHS = ("zamba2-2.7b", "moonshot-v1-16b-a3b")
B, PROMPT, SMAX = 4, 32, 64


def serve(out: Path, arch: str):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.dist.sharding import make_mesh, use_mesh
    from repro.launch.serve import cache_shardings, params_shardings
    from repro.models import transformer as tf
    from torch_mesh_ref import flat
    cfg = dataclasses.replace(reduced_config(arch), vocab=512,
                              dtype="float32")
    mesh = make_mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (2, B, 1)).astype(np.int32)
    res = {"tokens": toks, "steps": steps}
    with use_mesh(mesh):
        params = tf.init_params(cfg, jax.random.PRNGKey(0))
        caches = tf.init_decode_caches(cfg, B, SMAX)
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
            pos = np.full((B,), PROMPT + i, np.int32)
            pos[1::2] -= 5      # odd rows rewrite earlier positions
            res[f"pos{i}"] = pos
            logits, caches = dec(params, caches, jnp.asarray(steps[i]),
                                 jnp.asarray(pos))
            res[f"logits_decode{i}"] = np.asarray(logits)
            res.update(flat(jax.device_get(caches), f"caches_decode{i}"))
    np.savez(out / f"serve_{arch}.npz", **res)


def main(out: str) -> None:
    import jax
    if len(jax.devices()) != 8:
        sys.exit(f"host device count is {len(jax.devices())}, wanted 8")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    for arch in ARCHS:
        serve(out, arch)
    print("MESH TP REF OK")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main(sys.argv[1])
