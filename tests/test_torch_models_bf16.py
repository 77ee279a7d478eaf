"""The port's model stack against the JAX package's at the configs' own
bfloat16, for each of the 10 architectures at ``reduced_config``: the
same steps and inputs as ``test_torch_models.py``.

Tolerance: max |port - reference| <= 6e-2 * max(1, max |reference|) per
compared tensor, about 16 bf16 units in the last place at the tensor's
scale (bf16 keeps 8 bits, 3.9e-3 relative).  XLA on the CPU keeps a
fused chain of bf16 elementwise ops in f32 and rounds once; the port
rounds after each op, as the reference's code is written.  Over the two
reduced layers this parts the two by up to 3.5e-2 (zamba2's caches).

The MoE archs route each token to its top 2 of 8 experts, a
discontinuous choice: where the bf16 difference upstream flips a
near-tied choice or moves a token across an expert's capacity, that
token's output moves by O(1).  For them the tolerance must hold at 75 %
of the positions (every logits row compared, pooled; every cache
leaf's rows), not at all of them; in float32 every position holds
(``test_torch_models.py``), and ``_moe_local`` alone is held in
``test_torch_models_layers.py``.

The greedy tokens must be equal wherever the reference's top-2 margin
exceeds twice the tolerance (at positions within it).
"""

import numpy as np
import pytest

from repro.configs import ALL_ARCHS
from repro_torch.configs import reduced_config
import torch_models_ref as R

TOL = 6e-2
MOE_SHARE = 0.75


@pytest.fixture(scope="module", params=ALL_ARCHS)
def run(request):
    ref = R.run_reference(request.param, "bfloat16")
    return request.param, ref, R.run_port(request.param, "bfloat16", ref)


def _row_errs(got, want, feature_dims=1):
    """Per-row error over the trailing ``feature_dims`` axes, relative to
    max(1, max |want|) over the whole tensor."""
    got, want = R.as_f32(got), R.as_f32(want)
    assert got.shape == want.shape
    axes = tuple(range(-feature_dims, 0))
    return np.abs(got - want).max(axis=axes).reshape(-1) / max(
        1.0, float(np.abs(want).max()))


def _greedy_equal(got, want, errs):
    got, want = R.as_f32(got), R.as_f32(want)
    v = got.shape[-1]
    got, want = got.reshape(-1, v), want.reshape(-1, v)
    top2 = np.sort(want, axis=-1)[:, -2:]
    wide = (top2[:, 1] - top2[:, 0]) > 2 * TOL * max(1.0, np.abs(
        want).max())
    check = wide & (errs <= TOL)
    np.testing.assert_array_equal(got[check].argmax(-1),
                                  want[check].argmax(-1))


def _check_logits(arch, pairs):
    errs = [_row_errs(g, w) for g, w in pairs]
    for (g, w), e in zip(pairs, errs):
        _greedy_equal(g, w, e)
    pooled = np.concatenate(errs)
    if reduced_config(arch).family == "moe":
        assert (pooled <= TOL).mean() >= MOE_SHARE, np.quantile(
            pooled, [0.5, 0.75, 1.0])
    else:
        assert pooled.max() <= TOL, pooled.max()


def _check_caches(arch, got, want):
    moe = reduced_config(arch).family == "moe"
    for path, g, w in zip(R.cache_errors(got, want), R.leaves(got),
                          R.leaves(want)):
        e = _row_errs(g, w, feature_dims=2 if g.ndim == 5 else 1)
        if moe:
            assert (e <= TOL).mean() >= MOE_SHARE, (path, e.max())
        else:
            assert e.max() <= TOL, (path, e.max())


def test_forward_matches_reference_bf16(run):
    arch, ref, got = run
    _check_logits(arch, [(got["forward"], ref["forward"])])


def test_prefill_matches_reference_bf16(run):
    arch, ref, got = run
    _check_logits(arch, [(got["prefill"][0], ref["prefill"][0])]
                  + [(got["forward"], ref["forward"])])
    _check_caches(arch, got["prefill"][1], ref["prefill"][1])


def test_decode_steps_match_reference_bf16(run):
    arch, ref, got = run
    _check_logits(arch, [(g[0], w[0]) for g, w in zip(got["decode"],
                                                     ref["decode"])]
                  + [(got["forward"], ref["forward"])])
    for (_, gc), (_, wc) in zip(got["decode"], ref["decode"]):
        _check_caches(arch, gc, wc)


def test_prefill_chunked_matches_reference_bf16(run):
    arch, ref, got = run
    assert ("chunked" in got) == ("chunked" in ref) == R.chunked_applies(
        reduced_config(arch))
    if "chunked" in ref:
        _check_logits(arch, [(got["chunked"][0], ref["chunked"][0])]
                      + [(got["forward"], ref["forward"])])
        _check_caches(arch, got["chunked"][1], ref["chunked"][1])
