"""Shared helpers of the ``test_torch_*`` parity tests — random weights made
with numpy from a seed (fed to both packages; JAX's own init is never
matched by seed), conversions between the two frameworks' tensors — and
the tests of the weight converter they rely on."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

# fp32 on the CPU in both frameworks: matmuls sum in different orders, so
# results agree to a few ulps per op, never bitwise.
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)   # one attention op
MODULE_TOL = dict(atol=1e-5, rtol=1e-5)   # one layer (projections + attention)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)    # logits after a stack of layers


def numpy_params(shape_tree, seed: int):
    """Fill a JAX parameter shape tree with seeded numpy values.

    Norm scales are 1 + noise; the router rows and every weight get a
    1/sqrt(fan_in) normal (the fan-in of the router ``w`` (H, h) is its last
    axis, of every other matrix its second-to-last); embeddings get a unit
    normal.  Returns nested dicts of float32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        shape = leaf.shape
        if keys[-1] in ("scale",):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if keys[-1] in ("bias", "b"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        if keys[-1] == "table":
            return rng.standard_normal(shape).astype(np.float32)
        fan_in = shape[-1] if "router" in keys else shape[-2]
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shape_tree)


@pytest.fixture
def one_cpu_thread():
    """One intra-op thread for the test.  The test workers share the CPU:
    with several threads per process, oversubscription slows a torch test
    up to ~20x, and the BLAS picks its thread count by load, which changes
    the order of float sums between two runs in one process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(tree):
    return jax.tree.map(jax.numpy.asarray, tree)


def t(a, dtype=None):
    """numpy / jax array -> torch tensor (CPU)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def torch_config(cfg_jax, impl: str | None = None):
    """The port's ``ModelConfig`` equal to a JAX one (``impl`` "pallas" maps
    to "kernel")."""
    from repro_torch.configs import base as tb

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(tb, type(obj).__name__)
            kw = {f.name: conv(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)}
            if cls is tb.MoSAConfig:
                kw["impl"] = {"pallas": "kernel"}.get(kw["impl"], kw["impl"])
            return cls(**kw)
        if isinstance(obj, tuple):
            return tuple(conv(o) for o in obj)
        return obj

    cfg = conv(cfg_jax)
    if impl is not None:
        cfg = dataclasses.replace(cfg, mosa=dataclasses.replace(cfg.mosa,
                                                                impl=impl))
    return cfg


def test_params_from_jax_maps_every_leaf():
    """Every JAX leaf lands in the port's state_dict under its name, with
    scan-stacked layers unstacked (unit u of ``pos0`` is layer u)."""
    from repro.configs.base import get_config
    from repro.nn.transformer import TransformerLM as JLM

    from repro_torch.convert import params_from_jax
    from repro_torch.nn.transformer import TransformerLM

    cfg = get_config("mosa-paper", preset="smoke", variant="mosa")
    params = numpy_params(jax.eval_shape(JLM(cfg).init, jax.random.PRNGKey(0)),
                          seed=0)
    sd = params_from_jax(cfg, params)
    model = TransformerLM(torch_config(cfg))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    stacked = params["layers"]["scan"]["pos0"]["mixer"]["sparse"]["wq"]
    for u in range(cfg.n_layers):
        np.testing.assert_array_equal(
            n(model.layers[u].mixer.sparse.wq), stacked[u])
    np.testing.assert_array_equal(n(model.unembed.w),
                                  params["unembed"]["w"])


def test_params_from_jax_keeps_bf16():
    from repro_torch.convert import _tensor
    import ml_dtypes
    a = np.arange(6, dtype=np.float32).reshape(2, 3).astype(ml_dtypes.bfloat16)
    out = _tensor(a)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), torch.arange(6.).reshape(2, 3))
