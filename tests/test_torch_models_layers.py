"""The port's model modules against the JAX package's, one function at a
time, in float32 on the CPU (``repro_torch.models``: layers, attention,
moe, mamba2, xlstm), and the port's init, interop and ``Model``.

Inputs come from a numpy seed; parameters from the reference's own init
functions, handed across as numpy.  Tolerance, unless a test says
otherwise: max |port - reference| <= 1e-5 * max(1, max |reference|)
(float32 sums in another order, XLA's fused multiply-adds, and its own
exp / tanh / log approximations part the two by a few units in the last
place, amplified by at most a few exponentials).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS, reduced_config as j_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.models import xlstm as jxlstm
from repro_torch.configs import reduced_config
from repro_torch.models import attention, interop, layers, mamba2, moe
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm
from torch_models_ref import as_f32, np_tree, rel_err

TOL = 1e-5


def close(got, want, tol=TOL):
    err = rel_err(got, want)
    assert err <= tol, f"rel err {err:.3e} > {tol:.0e}"


def t(x):
    """A numpy array (or JAX tree of arrays) as CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def cfgs(arch, **kw):
    """The reference's and the port's reduced config, float32."""
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(j_reduced(arch), **kw),
            dataclasses.replace(reduced_config(arch), **kw))


def jit(fn, *args):
    """A reference function run jitted: a few compiles in place of one
    for every op of a scan body."""
    return jax.jit(fn)(*args)


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x, scale = normal(rng, 3, 5, 64, scale=3.0), normal(rng, 64, scale=0.1)
    close(layers.apply_norm(t(scale), t(x), kind),
          jlayers.apply_norm(scale, x, kind))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp(act):
    jcfg, _ = cfgs("gemma-2b", act=act)
    p = np_tree(jlayers.mlp_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = normal(np.random.default_rng(1), 2, 7, jcfg.d_model)
    close(layers.apply_mlp(t(p), t(x), act), jlayers.apply_mlp(p, x, act))


@pytest.mark.parametrize("arch", ["gemma2-27b", "mistral-nemo-12b"])
def test_embed_and_unembed(arch):
    """gemma2: tied and scaled by sqrt(d), final softcap 30; mistral:
    untied, unscaled."""
    jcfg, cfg = cfgs(arch)
    key = jax.random.PRNGKey(0)
    p = {"embed": jlayers.embed_init(key, jcfg, jnp.float32),
         "unembed": jlayers.embed_init(jax.random.PRNGKey(1), jcfg,
                                       jnp.float32)}
    p = np_tree(p)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 9))
    x = jlayers.embed_apply(p["embed"], toks, jcfg.embed_scale)
    got = layers.embed_apply(t(p["embed"]), t(toks), cfg.embed_scale)
    close(got, x, 0.0)
    close(layers.unembed_apply(cfg, t(p), got),
          jlayers.unembed_apply(jcfg, p, x))


def test_embed_scale_rounds_to_bf16_first():
    """sqrt(2048) is 45.25 in bf16: the product is taken with the rounded
    scale, bit for bit as the reference."""
    rng = np.random.default_rng(3)
    table = jnp.asarray(normal(rng, 16, 2048), jnp.bfloat16)
    toks = np.arange(16).reshape(2, 8)
    want = np_tree(jlayers.embed_apply(table, toks, True))
    got = layers.embed_apply(t(np_tree(table)).view(torch.bfloat16),
                             t(toks), True)
    np.testing.assert_array_equal(interop.to_numpy(got), want)


def test_scan_cumsum_adds_in_xlas_order():
    rng = np.random.default_rng(4)
    for n in (1, 16, 17, 100, 512):
        x = normal(rng, 3, n, 2, scale=3.0)
        got = layers.scan_cumsum(t(x), 1).numpy()
        np.testing.assert_array_equal(got.view(np.int32), np.asarray(
            jnp.cumsum(x, axis=1)).view(np.int32))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, None, None, 0), (True, 24, None, 0), (True, None, 50.0, 0),
    (False, None, None, 0), (True, 16, 20.0, 32)])
def test_chunked_attention(causal, window, softcap, q_offset):
    """96 queries in chunks of 32 against 128 keys in chunks of 32 (64 for
    the offset case's cache-length keys)."""
    rng = np.random.default_rng(5)
    sk = 96 + q_offset
    q = normal(rng, 2, 96, 2, 2, 16)
    k, v = normal(rng, 2, sk, 2, 16), normal(rng, 2, sk, 2, 16)
    kw = dict(causal=causal, window=window, softcap=softcap, q_chunk=32,
              kv_chunk=32, q_offset=q_offset)
    close(attention.chunked_attention(t(q), t(k), t(v), **kw),
          jattn.chunked_attention(q, k, v, **kw))


@pytest.fixture(scope="module")
def attn_case():
    jcfg, cfg = cfgs("gemma2-27b")      # softcap 50
    p = np_tree(jattn.attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    return jcfg, cfg, p, np.random.default_rng(6)


@pytest.mark.parametrize("window", [None, 16])
def test_attn_apply_prefill(attn_case, window):
    jcfg, cfg, p, rng = attn_case
    x = normal(rng, 2, 64, jcfg.d_model)
    jc = jattn.init_cache(jcfg, 2, 72, jnp.float32)
    jy, jc = jattn.attn_apply(p, jcfg, x, window=window, cache=jc)
    c = attention.init_cache(cfg, 2, 72, torch.float32, "cpu")
    y, c = attention.attn_apply(t(p), cfg, t(x), window=window, cache=c)
    close(y, jy)
    close(c.k, jc.k)
    close(c.v, jc.v)


@pytest.mark.parametrize("window", [None, 8])
def test_attn_apply_decode_rows_at_different_positions(attn_case, window):
    jcfg, cfg, p, rng = attn_case
    kv = (cfg.n_kv_heads, cfg.head_dim)
    ck, cv = normal(rng, 3, 40, *kv), normal(rng, 3, 40, *kv)
    pos = np.array([[39], [7], [20]], np.int32)
    x = normal(rng, 3, 1, jcfg.d_model)
    jy, jc = jattn.attn_apply(p, jcfg, x, window=window, positions=pos,
                              cache=jattn.KVCache(jnp.asarray(ck),
                                                  jnp.asarray(cv)))
    c = attention.KVCache(t(ck), t(cv))
    y, c2 = attention.attn_apply(t(p), cfg, t(x), window=window,
                                 positions=t(pos), cache=c)
    assert c2.k is c.k and c2.v is c.v         # written in place
    close(y, jy)
    close(c.k, jc.k)
    close(c.v, jc.v)


def test_attn_apply_chunked_prefill(attn_case):
    jcfg, cfg, p, rng = attn_case
    kv = (cfg.n_kv_heads, cfg.head_dim)
    ck, cv = normal(rng, 2, 64, *kv), normal(rng, 2, 64, *kv)
    x = normal(rng, 2, 16, jcfg.d_model)
    jy, jc = jattn.attn_apply(p, jcfg, x, window=24, cache=jattn.KVCache(
        ck, cv), chunk_offset=32)
    c = attention.KVCache(t(ck), t(cv))
    y, c = attention.attn_apply(t(p), cfg, t(x), window=24, cache=c,
                                chunk_offset=32)
    close(y, jy)
    close(c.k, jc.k)
    close(c.v, jc.v)


def test_attn_apply_cross(attn_case):
    jcfg, cfg, p, rng = attn_case
    x, kv = normal(rng, 2, 8, jcfg.d_model), normal(rng, 2, 20, jcfg.d_model)
    jy, _ = jattn.attn_apply(p, jcfg, x, kv_x=kv, causal=False)
    y, _ = attention.attn_apply(t(p), cfg, t(x), kv_x=t(kv), causal=False)
    close(y, jy)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_local_drops_and_aux(capacity_factor):
    """At capacity factor 0.5 most experts overflow and drop assignments
    (counted below); 1.25 is the configs' own."""
    jcfg, cfg = cfgs("qwen3-moe-235b-a22b", capacity_factor=capacity_factor)
    p = np_tree(jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    x = normal(np.random.default_rng(7), 2, 24, jcfg.d_model)
    jy, jaux = jit(lambda p, x: jmoe._moe_local(p, jcfg, x), p, x)
    y, aux = moe._moe_local(t(p), cfg, t(x))
    close(y, jy)
    close(aux, jaux)
    if capacity_factor < 1:    # the case really drops assignments
        probs = torch.softmax(t(x).reshape(48, -1) @ t(p["router"]), -1)
        load = torch.bincount(probs.topk(cfg.top_k).indices.reshape(-1),
                              minlength=cfg.n_experts)
        assert int((load - moe.capacity(cfg, 48)).clamp(min=0).sum()) > 0


def test_moe_top_k_breaks_ties_toward_the_lower_index():
    """A router whose logits tie exactly (zero weights on some experts):
    the reference's lax.top_k picks the lower index, and so must the
    port."""
    jcfg, cfg = cfgs("moonshot-v1-16b-a3b")
    p = jax.tree.map(np.array, np_tree(jmoe.moe_init(
        jax.random.PRNGKey(1), jcfg, jnp.float32)))
    p["router"][:, ::2] = 0.0                  # every even expert ties
    p["router"][:, 1::2] *= 0.01
    x = normal(np.random.default_rng(8), 1, 16, jcfg.d_model)
    jy, jaux = jmoe._moe_local(p, jcfg, x)
    y, aux = moe._moe_local(t(p), cfg, t(x))
    close(y, jy)
    close(aux, jaux)


# ---------------------------------------------------------------------------
# mamba2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_case():
    jcfg, cfg = cfgs("zamba2-2.7b", ssm_chunk=16)
    p = np_tree(jmamba.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    p["dt_bias"] = normal(np.random.default_rng(9), jcfg.ssm_heads)
    return jcfg, cfg, p


def _mamba_cache(cache):
    return mamba2.MambaCache(t(cache.conv), t(cache.ssd))


def test_mamba_apply_over_chunks_then_from_its_cache(mamba_case):
    """64 tokens in four chunks of 16, then 32 more from the cache."""
    jcfg, cfg, p = mamba_case
    rng = np.random.default_rng(10)
    u1, u2 = normal(rng, 2, 64, jcfg.d_model), normal(rng, 2, 32,
                                                      jcfg.d_model)
    jy1, jc = jit(lambda p, u: jmamba.mamba_apply(p, jcfg, u), p, u1)
    y1, c = mamba2.mamba_apply(t(p), cfg, t(u1))
    close(y1, jy1)
    close(c.conv, jc.conv)
    close(c.ssd, jc.ssd)
    y2, c = mamba2.mamba_apply(t(p), cfg, t(u2), cache=_mamba_cache(jc))
    jy2, jc = jit(lambda p, u, c: jmamba.mamba_apply(p, jcfg, u, cache=c),
                  p, u2, jc)
    close(y2, jy2)
    close(c.conv, jc.conv)
    close(c.ssd, jc.ssd)


def test_mamba_decode(mamba_case):
    jcfg, cfg, p = mamba_case
    rng = np.random.default_rng(11)
    _, jc = jit(lambda p, u: jmamba.mamba_apply(p, jcfg, u), p,
                normal(rng, 2, 32, jcfg.d_model))
    for _ in range(2):
        u = normal(rng, 2, 1, jcfg.d_model)
        y, c = mamba2.mamba_decode(t(p), cfg, t(u), _mamba_cache(jc))
        jy, jc = jmamba.mamba_decode(p, jcfg, u, jc)
        close(y, jy)
        close(c.conv, jc.conv)
        close(c.ssd, jc.ssd)


# ---------------------------------------------------------------------------
# xlstm
# ---------------------------------------------------------------------------

def test_mlstm_apply_and_decode():
    """128 tokens in four chunks of 32, the final state handed to two
    decode steps."""
    jcfg, cfg = cfgs("xlstm-350m")
    p = np_tree(jxlstm.mlstm_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(12)
    x = normal(rng, 2, 128, jcfg.d_model)
    jy, jc = jit(lambda p, x: jxlstm.mlstm_apply(p, jcfg, x, chunk=32), p, x)
    y, c = xlstm.mlstm_apply(t(p), cfg, t(x), chunk=32)
    close(y, jy)
    for got, want in zip(c, jc):
        close(got, want)
    for _ in range(2):
        u = normal(rng, 2, 1, jcfg.d_model)
        y, c = xlstm.mlstm_decode(t(p), cfg, t(u), xlstm.MLSTMCache(
            *t(tuple(jc))))
        jy, jc = jxlstm.mlstm_decode(p, jcfg, u, jc)
        close(y, jy)
        for got, want in zip(c, jc):
            close(got, want)


def test_slstm_apply_and_decode():
    """48 steps of the recurrence from a zero state, 16 more from its
    cache, then two decode steps."""
    jcfg, cfg = cfgs("xlstm-350m")
    p = np_tree(jxlstm.slstm_init(jax.random.PRNGKey(0), jcfg, jnp.float32))
    rng = np.random.default_rng(13)
    x1, x2 = normal(rng, 2, 48, jcfg.d_model), normal(rng, 2, 16,
                                                      jcfg.d_model)
    jy, jc = jit(lambda p, x: jxlstm.slstm_apply(p, jcfg, x), p, x1)
    y, c = xlstm.slstm_apply(t(p), cfg, t(x1))
    close(y, jy)
    jy, jc = jit(lambda p, x, c: jxlstm.slstm_apply(p, jcfg, x, cache=c),
                 p, x2, jc)
    y, c = xlstm.slstm_apply(t(p), cfg, t(x2), cache=xlstm.SLSTMCache(
        *(torch.from_numpy(np.asarray(a)) for a in c)))
    close(y, jy)
    for _ in range(2):
        u = normal(rng, 2, 1, jcfg.d_model)
        y, c = xlstm.slstm_decode(t(p), cfg, t(u), c)
        jy, jc = jxlstm.slstm_decode(p, jcfg, u, jc)
        close(y, jy)
        for got, want in zip(c, jc):
            close(got, want)


# ---------------------------------------------------------------------------
# init, interop and the module
# ---------------------------------------------------------------------------

def _paths(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_params_matches_reference_tree_and_statistics(arch):
    """The same leaves (paths, shapes, dtypes) at the configs' own bf16;
    each leaf's mean and std within sampling error of the reference's
    (five standard errors of the mean; the std within 5 %, or 0.02 for a
    leaf of fewer than 1000 values)."""
    jcfg, cfg = cfgs(arch, dtype="bfloat16")
    want = _paths(np_tree(jtf.init_params(jcfg, jax.random.PRNGKey(0))))
    got = _paths(interop.to_numpy(tf.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        g, w = as_f32(g).astype(np.float64), as_f32(w).astype(np.float64)
        sem = max(w.std(), 1e-12) / np.sqrt(w.size)
        assert abs(g.mean() - w.mean()) <= 5 * sem + 1e-7, path
        rtol = 0.05 if w.size >= 1000 else 0.2
        assert abs(g.std() - w.std()) <= rtol * w.std() + 0.02 * (
            w.size < 1000), path
    assert tf.param_count(tf.init_params(cfg, None, "meta")) == sum(
            np.size(v) for v in want.values())


def test_interop_checks_every_leaf():
    jcfg, cfg = cfgs("zamba2-2.7b", dtype="bfloat16")
    ref = np_tree(jtf.init_params(jcfg, jax.random.PRNGKey(0)))
    params = interop.params_from_numpy(cfg, ref, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    back = _paths(interop.to_numpy(params))
    for path, w in _paths(ref).items():
        np.testing.assert_array_equal(back[path], w)
    bad = jax.tree.map(lambda a: a, ref)
    bad["stack"]["p5"]["norm"] = bad["stack"]["p5"]["norm"][:, :-1]
    with pytest.raises(ValueError, match=r"stack\.p5\.norm"):
        interop.params_from_numpy(cfg, bad, "cpu")
    bad = jax.tree.map(lambda a: a, ref)
    bad["embed"] = bad["embed"].astype(np.float32)
    with pytest.raises(ValueError, match="embed: got float32"):
        interop.params_from_numpy(cfg, bad, "cpu")
    caches = np_tree(jtf.init_decode_caches(jcfg, 2, 16))
    got = interop.caches_from_numpy(cfg, caches, 2, 16, "cpu")
    assert isinstance(got["p5"], attention.KVCache)
    assert isinstance(got["p0"], mamba2.MambaCache)
    with pytest.raises(ValueError, match=r"p0\[0\]: got uint16 \(1, 2, "):
        interop.caches_from_numpy(cfg, caches, 3, 16, "cpu")
    assert got["p0"].conv.shape[:2] == (1, 2)
    # an enc-dec arch's caches after prefill carry the cross K/V pair
    jcfg, cfg = cfgs("whisper-tiny", dtype="bfloat16")
    caches = np_tree(jtf.init_decode_caches(jcfg, 2, 16))
    xkv = np.zeros((cfg.pattern_reps, 2, cfg.enc_seq, cfg.n_kv_heads,
                    cfg.head_dim), np.uint16)
    caches["xkv"] = (xkv, xkv + 0x3F80)               # 0 and 1.0 in bf16
    got = interop.caches_from_numpy(cfg, caches, 2, 16, "cpu")
    assert float(got["xkv"][1].float().mean()) == 1.0
    np.testing.assert_array_equal(interop.to_numpy(got)["xkv"][1],
                                  caches["xkv"][1])


def test_model_owns_the_tree():
    """``Model`` registers every leaf under its tree path, moves with
    ``.to()`` and binds the module functions to its parameters."""
    _, cfg = cfgs("gemma2-27b")
    m = tf.Model(cfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    leaves = _paths(interop.to_numpy(m.params()))
    assert len(m.state_dict()) == len(leaves)
    assert "stack.p1.attn.wq" in m.state_dict()
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    logits, _ = m(toks)
    want, _ = tf.forward(cfg, m.params(), toks)
    assert torch.equal(logits, want)
    last, _ = m.prefill(toks, m.init_decode_caches(2, 12))
    assert not torch.is_inference_mode_enabled()
    close(last[:, 0], logits[:, -1])
    assert m.to(torch.float64).params()["embed"].dtype == torch.float64
