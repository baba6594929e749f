"""The port's layers against the JAX package on the same numpy inputs:
RoPE, RMSNorm, the MLP, the expert-choice router and the streaming top-k
update.  fp32 on the CPU; tolerance 1e-5 (one op or one small layer —
summation order differs between the frameworks, so not bitwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rope as jrope
from repro.core import router as jrouter
from repro.nn.ffn import MLP as JMLP
from repro.nn.layers import RMSNorm as JRMSNorm

from repro_torch.core import rope as trope
from repro_torch.core import router as trouter
from repro_torch.nn.ffn import MLP
from repro_torch.nn.layers import RMSNorm

from test_torch_parity import MODULE_TOL, n, t

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("rotary_frac", [0.5, 1.0])
def test_apply_rope_matches_jax(rotary_frac):
    x = RNG.standard_normal((2, 3, 7, 64)).astype(np.float32)
    pos = RNG.integers(0, 1200, (2, 3, 7)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                            rotary_frac)
    got = trope.apply_rope(t(x), t(pos), 10000.0, rotary_frac)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rmsnorm_matches_jax():
    x = RNG.standard_normal((2, 5, 32)).astype(np.float32)
    scale = (1 + 0.1 * RNG.standard_normal(32)).astype(np.float32)
    want = JRMSNorm(32)({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    m = RMSNorm(32)
    m.load_state_dict({"scale": t(scale)})
    np.testing.assert_allclose(n(m(t(x))), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_matches_jax(act):
    d, ff = 32, 64
    names = (["w_in", "w_out"] if act == "gelu"
             else ["w_gate", "w_up", "w_down"])
    params = {k: (RNG.standard_normal((ff, d) if k in ("w_out", "w_down")
                                      else (d, ff)) / 6).astype(np.float32)
              for k in names}
    x = RNG.standard_normal((2, 5, d)).astype(np.float32)
    want = JMLP(d, ff, act)({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x))
    m = MLP(d, ff, act)
    m.load_state_dict({k: t(v) for k, v in params.items()})
    np.testing.assert_allclose(n(m(t(x))), np.asarray(want), **MODULE_TOL)


@pytest.mark.parametrize("k,force_first", [(5, True), (5, False), (1, True)])
def test_router_scores_and_select_topk_match_jax(k, force_first):
    """Scores match to 1e-5; the selected index sets match exactly (the
    random scores are distinct, so no tie decides the selection)."""
    B, T, h, H = 2, 16, 32, 4
    w = (RNG.standard_normal((H, h)) / np.sqrt(h)).astype(np.float32)
    x = RNG.standard_normal((B, T, h)).astype(np.float32)
    js = jrouter.ExpertChoiceRouter(h, H).scores({"w": jnp.asarray(w)},
                                                jnp.asarray(x))
    router = trouter.ExpertChoiceRouter(h, H)
    router.load_state_dict({"w": t(w)})
    ts = router.scores(t(x))
    np.testing.assert_allclose(n(ts), np.asarray(js), **MODULE_TOL)
    assert len(np.unique(np.asarray(js))) == js.size       # distinct scores
    jr, jidx = jrouter.select_topk(js, k, force_first)
    tr, tidx = trouter.select_topk(t(np.asarray(js)), k, force_first)
    np.testing.assert_array_equal(n(tidx), np.asarray(jidx))
    np.testing.assert_array_equal(n(tr), np.asarray(jr))
    assert (np.diff(n(tidx), axis=-1) > 0).all()           # sorted ascending


@pytest.mark.parametrize("force_first", [True, False])
def test_select_topk_breaks_ties_like_jax(force_first):
    """Equal scores (a prompt repeating a token gives its copies equal
    first-layer router scores) are taken lower index first, as
    ``lax.top_k`` does — the selected index sets match exactly."""
    scores = np.round(RNG.random((2, 5, 40)), 1).astype(np.float32)  # many ties
    for k in (1, 3, 9, 40):
        jr, jidx = jrouter.select_topk(jnp.asarray(scores), k, force_first)
        tr, tidx = trouter.select_topk(t(scores), k, force_first)
        np.testing.assert_array_equal(n(tidx), np.asarray(jidx))
        np.testing.assert_array_equal(n(tr), np.asarray(jr))


def test_selection_mask_matches_jax():
    idx = RNG.integers(-1, 20, (2, 3, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        n(trouter.selection_mask(t(idx), t(idx))),
        np.asarray(jrouter.selection_mask(jnp.asarray(idx), jnp.asarray(idx))))


def test_streaming_topk_update_matches_jax():
    """Evict-min with empty (-inf / -1) slots filling first, a forced
    insertion, and a token that loses to every slot."""
    scores = np.array([[0.3, -np.inf, 0.9, -np.inf],
                       [0.5, 0.6, 0.7, 0.8],
                       [0.5, 0.6, 0.7, 0.8]], np.float32)
    idx = np.array([[1, -1, 4, -1], [0, 2, 3, 5], [0, 2, 3, 5]], np.int32)
    new_score = np.array([0.1, 0.55, 0.2], np.float32)
    forced = np.array([False, False, True])
    want = jrouter.streaming_topk_update(
        jnp.asarray(scores), jnp.asarray(idx), jnp.asarray(new_score), 7,
        jnp.asarray(forced))
    got = trouter.streaming_topk_update(
        t(scores), t(idx, torch.long), t(new_score), 7, t(forced))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))
