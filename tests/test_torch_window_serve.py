"""Serving the window model against the JAX package on the CPU: the smoke
``mosa-paper`` hybrid with ``local_window=16`` (4 sliding-window dense
heads beside the MoSA heads), token choice and block choice (whose two
sides the learned gates blend), served by ``Server.generate`` over
contiguous window rings and over identity-paged ones (``PagedConfig(8)``),
with the port's dense side on the flash route (``dense_impl="kernel"``,
its plain version on the CPU).  Weights are made by numpy from a seed and
carried across with ``convert.py``.

Greedy tokens must be identical; the prefill logits and every decode
step's logits within 1e-4 (``MODEL_TOL``: a stack of layers in another
summation order).  The 24-token prompts and 10 generated tokens run the
16-slot ring past its wrap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.launch.serve import Server as JServer
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig as JPagedConfig

from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import Server
from repro_torch.serve.paged_kv import PagedConfig

from test_torch_parity import (MODEL_TOL, n, numpy_params,  # noqa: F401
                               one_cpu_thread, to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

B, P, G, MAX_LEN = 2, 24, 10, 40


def _window_cfg(block):
    kw = dict(selection_granularity="block", sel_block_size=8) if block else {}
    return get_config("mosa-paper", preset="smoke", variant="mosa",
                      local_window=16, **kw)


@pytest.mark.parametrize("block", [False, True], ids=["token", "block"])
@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
def test_window_generate_matches_jax(block, paged):
    cfg = _window_cfg(block)
    params = numpy_params(jax.eval_shape(JLM(cfg).init,
                                         jax.random.PRNGKey(0)), seed=5)
    jsrv = JServer(cfg, batch=B, max_len=MAX_LEN, params=to_jax(params),
                   paged=JPagedConfig(8) if paged else None)
    tsrv = Server(torch_config(cfg), batch=B, max_len=MAX_LEN,
                  params=params_from_jax(cfg, params),
                  paged=PagedConfig(8) if paged else None, device="cpu")
    for layer in tsrv.model.layers:
        layer.mixer.dense_impl = "kernel"
    prompts = np.random.default_rng(6).integers(2, cfg.vocab, (B, P))
    jt, jc = jsrv.generate(jnp.asarray(prompts), G)
    tt, tc = tsrv.generate(torch.from_numpy(prompts), G)
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    ring = "PagedWindowKVCache" if paged else "WindowKVCache"
    assert [type(c["dense"]).__name__ for c in tc] == [ring] * cfg.n_layers
    if block:
        assert tsrv.model.layers[0].mixer._gated()

    # logits of the same run: the prefill, then each greedy decode step
    jlm, jp = jsrv.model, jsrv.params
    jcache = jsrv.new_cache()
    jl, jcache = jax.jit(jlm.prefill)(jp, jnp.asarray(prompts), jcache)
    tok = jnp.asarray(np.asarray(jt)[:, :1])
    _, jdl, _ = jax.jit(jlm.decode_many, static_argnums=(4, 6, 7))(
        jp, tok, jcache, None, G - 1, 0.0, 0, True)
    with torch.inference_mode():
        tl, tcache = tsrv.model.prefill(torch.from_numpy(prompts),
                                        tsrv.new_cache())
        _, tdl, _ = tsrv.model.decode_many(tt[:, :1], tcache, n=G - 1,
                                           return_logits=True)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_allclose(n(tdl), np.asarray(jdl), **MODEL_TOL)
