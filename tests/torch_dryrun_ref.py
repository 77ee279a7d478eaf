"""The JAX package's lowerings on an 8-device host mesh, for the dry-run
tests (``tests/test_torch_dryrun.py``): run as a script in its own
process with eight forced host devices, it writes ``ref.json`` and
``chunked_<arch>.npz`` into the directory given:

* ``ref.json``: for each (arch, kind) of ``LOWER``, the reference's own
  ``lower_train_step`` / ``lower_prefill_step`` / ``lower_serve_step`` at
  the reduced config on a (2, 4) mesh at the shapes of ``specs``,
  compiled: ``memory_analysis().argument_size_in_bytes`` and the
  trip-corrected FLOPs of ``hlo_stats.analyze`` (both per device);
* ``chunked_<arch>.npz``: ``prefill_chunked`` of the reduced config
  (2 layers, vocab 512, float32) jitted on a (2, 4) mesh with the
  parameters and caches placed by ``params_shardings`` /
  ``cache_shardings``: the parameters, the prompt, the last logits and
  the caches gathered after it.

Imported (by the tests, for its constants and ``specs``) it touches no
JAX state.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

#: the (arch, kind) cells the lowerings are compared on
LOWER = [(a, k) for a in ("gemma-2b", "moonshot-v1-16b-a3b")
         for k in ("train", "prefill", "decode")] + [
    ("zamba2-2.7b", "prefill"), ("zamba2-2.7b", "decode")]
N_MICRO = 2
CHUNKED = {"gemma-2b": dict(n_layers=2, vocab=512),
           "zamba2-2.7b": dict(vocab=512)}
CHUNK_B, CHUNK_S, CHUNK_LEN = 4, 64, 32


def specs(cfg, kind: str):
    """name -> (shape, dtype name) of each step input at the test's
    shapes (frontend extras at the config's widths)."""
    dt = cfg.dtype
    if kind == "decode":
        return {"token": ((4, 1), "int32"), "pos": ((4,), "int32")}
    b, s = (8, 32) if kind == "train" else (4, 32)
    out = {"tokens": ((b, s), "int32")}
    if kind == "train":
        out["labels"] = ((b, s), "int32")
    if cfg.frontend == "vit":
        out["prefix_embeds"] = ((b, cfg.frontend_tokens, cfg.d_model), dt)
    if cfg.frontend == "audio":
        out["enc_frames"] = ((b, cfg.enc_seq, cfg.d_model), dt)
    return out


#: the decode caches' length
DECODE_SMAX = 64


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


def lowerings(out: Path):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.dist.sharding import make_mesh
    from repro.launch.serve import lower_prefill_step, lower_serve_step
    from repro.launch.train import TrainConfig, lower_train_step
    from repro.roofline.hlo_stats import analyze
    mesh = make_mesh((2, 4), ("data", "model"))
    res = {}
    for arch, kind in LOWER:
        cfg = reduced_config(arch)
        sp = {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
              for k, (s, d) in specs(cfg, kind).items()}
        if kind == "train":
            low = lower_train_step(cfg, TrainConfig(n_micro=N_MICRO), mesh,
                                   sp)
        elif kind == "prefill":
            b, s = sp["tokens"].shape
            low = lower_prefill_step(cfg, mesh, batch=b, seq_len=s,
                                     specs=sp)
        else:
            low = lower_serve_step(cfg, mesh, batch=sp["token"].shape[0],
                                   seq_len=DECODE_SMAX, specs=sp)
        comp = low.compile()
        res[f"{arch}/{kind}"] = {
            "argument_bytes": int(
                comp.memory_analysis().argument_size_in_bytes),
            "flops": analyze(comp.as_text()).flops}
    (out / "ref.json").write_text(json.dumps(res, indent=1))


def chunked(out: Path, arch: str):
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.dist.sharding import make_mesh, use_mesh
    from repro.launch.serve import cache_shardings, params_shardings
    from repro.models import transformer as tf
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32",
                              **CHUNKED[arch])
    mesh = make_mesh((2, 4), ("data", "model"))
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, (CHUNK_B, CHUNK_S)).astype(np.int32)
    with use_mesh(mesh):
        params = tf.init_params(cfg, jax.random.PRNGKey(0))
        caches = tf.init_decode_caches(cfg, CHUNK_B, CHUNK_S)
        res = {"tokens": toks, **flat(params, "params")}
        p_sh = params_shardings(cfg, mesh, jax.eval_shape(lambda: params))
        c_sh = cache_shardings(cfg, mesh, jax.eval_shape(lambda: caches))
        params = jax.tree.map(jax.device_put, params, p_sh)
        caches = jax.tree.map(jax.device_put, caches, c_sh)
        logits, caches = jax.jit(lambda p, c, t: tf.prefill_chunked(
            cfg, p, t, c, chunk_len=CHUNK_LEN))(params, caches,
                                                jnp.asarray(toks))
        res["logits"] = np.asarray(logits)
        res.update(flat(jax.device_get(caches), "caches"))
    np.savez(out / f"chunked_{arch}.npz", **res)


def main(out: str) -> None:
    import jax
    if len(jax.devices()) != 8:
        sys.exit(f"host device count is {len(jax.devices())}, wanted 8")
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    lowerings(out)
    for arch in CHUNKED:
        chunked(out, arch)
    print("DRYRUN REF OK")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    main(sys.argv[1])
