"""The port's serving slice as a whole against the JAX package: paged MoSA
serving of the ``mosa-paper`` smoke model with the kernel path selected
(``impl="pallas"`` in JAX, run in interpret mode on the CPU; ``"kernel"`` in
the port, whose wrappers take their plain versions on CPU tensors)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config
from repro.launch.serve import Server
from repro.serve.paged_kv import PagedConfig

from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import Server as TServer
from repro_torch.serve.paged_kv import PagedConfig as TPagedConfig

from test_torch_parity import MODEL_TOL, n, numpy_params, to_jax, torch_config

B, P, G, MAX_LEN = 2, 24, 8, 64


@pytest.fixture(scope="module")
def servers():
    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                            impl="pallas"))
    from repro.nn.transformer import TransformerLM
    shapes = jax.eval_shape(TransformerLM(cfg).init, jax.random.PRNGKey(0))
    params = numpy_params(shapes, seed=0)
    jsrv = Server(cfg, batch=B, max_len=MAX_LEN, params=to_jax(params),
                  paged=PagedConfig(block_size=16))
    tsrv = TServer(torch_config(cfg), batch=B, max_len=MAX_LEN,
                   params=params_from_jax(cfg, params),
                   paged=TPagedConfig(block_size=16), device="cpu")
    prompts = np.random.default_rng(1).integers(2, cfg.vocab, (B, P),
                                                dtype=np.int32)
    return cfg, jsrv, tsrv, prompts


def test_slice_prefill_and_decode_logits_match_jax(servers):
    """Prefill logits and 8 steps of decode logits agree with the JAX
    package to 1e-4 (fp32; summation order differs per op, and 2 layers of
    projections, routing and attention accumulate it), and the greedy
    tokens are identical."""
    cfg, jsrv, tsrv, prompts = servers
    assert tsrv.model_cfg.mosa.impl == "kernel"
    with jsrv.mesh:
        jl, jc = jsrv.prefill(jsrv.params, jnp.asarray(prompts),
                              jsrv.new_cache())
        jtok0 = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        decode = jax.jit(jsrv.model.decode_many,
                         static_argnames=("n", "return_logits"))
        jtoks, jlog, _ = decode(jsrv.params, jtok0, jc, None, n=G,
                                return_logits=True)
    with torch.inference_mode():
        tl, tc = tsrv.model.prefill(torch.from_numpy(prompts).long(),
                                    tsrv.new_cache())
        ttok0 = tl[:, -1].argmax(-1)[:, None]
        ttoks, tlog, _ = tsrv.model.decode_many(ttok0, tc, None, n=G,
                                                return_logits=True)
    assert tl.shape == (B, 1, cfg.vocab) and tlog.shape == (B, G, cfg.vocab)
    np.testing.assert_allclose(n(tl), np.asarray(jl), **MODEL_TOL)
    np.testing.assert_array_equal(n(ttok0), np.asarray(jtok0))
    np.testing.assert_allclose(n(tlog), np.asarray(jlog), **MODEL_TOL)
    np.testing.assert_array_equal(n(ttoks), np.asarray(jtoks))


def test_slice_generate_tokens_match_jax(servers):
    """``Server.generate`` (the user's entry point) emits the JAX server's
    greedy tokens."""
    cfg, jsrv, tsrv, prompts = servers
    jt, _ = jsrv.generate(jnp.asarray(prompts), G)
    tt, caches = tsrv.generate(torch.from_numpy(prompts), G)
    np.testing.assert_array_equal(n(tt), np.asarray(jt))
    # the dense heads' paged pools hold exactly prompt + decoded tokens
    assert all(int(c["dense"].length[0]) == P + G - 1 for c in caches)


def test_slice_runs_kernel_path_on_cpu_plain_versions(servers):
    """On CPU tensors the kernel wrappers take their plain versions and
    never count a launch."""
    from repro_torch.kernels import mosa_attention as km
    from repro_torch.serve import paged_attention as kp
    _, _, tsrv, prompts = servers
    before = (km.LAUNCHES.count, kp.LAUNCHES.count)
    tsrv.generate(torch.from_numpy(prompts), 3)
    assert (km.LAUNCHES.count, kp.LAUNCHES.count) == before
