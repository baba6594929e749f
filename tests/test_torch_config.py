"""The port's configuration dataclasses mirror the JAX package's, field by
field, and the ``mosa-paper`` registry builds the same configurations."""

import dataclasses

import pytest
import torch

from repro.configs import base as jb
from repro.configs.base import get_config as jax_get_config

from repro_torch.configs import base as tb
from repro_torch.configs.base import get_config
from repro_torch.core import flops as tflops
from repro.core import flops as jflops

MIRRORED = ("MoEConfig", "MLAConfig", "MoSAConfig", "MambaConfig",
            "XLSTMConfig", "AttentionConfig", "BlockSpec", "ModelConfig")


@pytest.mark.parametrize("name", MIRRORED)
def test_dataclass_fields_match_jax(name):
    ours = [(f.name, f.default) for f in dataclasses.fields(getattr(tb, name))]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(getattr(jb, name))]
    assert [f for f, _ in ours] == [f for f, _ in theirs]
    assert ours == theirs


def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    if d["mosa"] is not None:
        d["mosa"]["impl"] = {"pallas": "kernel"}.get(d["mosa"]["impl"],
                                                     d["mosa"]["impl"])
    return d


@pytest.mark.parametrize("preset,n_mosa,n_layers,vocab", [
    ("full", 276, 6, 8000), ("smoke", 42, 2, 512)])
def test_mosa_paper_configs_match_jax(preset, n_mosa, n_layers, vocab):
    """mosa-paper-tiny-mosa32 (full) and its smoke cut agree field by field
    with the JAX registry, ``impl`` mapped pallas <-> kernel."""
    ours = get_config("mosa-paper", preset=preset, size="tiny",
                      variant="mosa")
    theirs = jax_get_config("mosa-paper", preset=preset, size="tiny",
                            variant="mosa")
    assert _as_dict(ours) == _as_dict(theirs)
    kernel = dataclasses.replace(ours.mosa, impl="kernel")
    pallas = dataclasses.replace(theirs.mosa, impl="pallas")
    assert _as_dict(dataclasses.replace(ours, mosa=kernel)) == \
        _as_dict(dataclasses.replace(theirs, mosa=pallas))
    assert ours.mosa.n_mosa_heads == n_mosa
    assert (ours.n_layers, ours.vocab, ours.d_model) == (n_layers, vocab, 512)
    assert ours.pdtype == ours.cdtype == torch.float32


@pytest.mark.parametrize("variant", ["dense", "mosa", "pure", "fixed"])
def test_mosa_paper_variants_match_jax(variant):
    assert _as_dict(get_config("mosa-paper", variant=variant)) == \
        _as_dict(jax_get_config("mosa-paper", variant=variant))


def test_flops_copy_matches_jax():
    """The copied IsoFLOP solver reproduces Table 5, as the JAX one does."""
    for size, table in jflops.TABLE5_HYBRID_HEADS.items():
        for sparsity, heads in table.items():
            assert tflops.PAPER_MODELS[size].hybrid_mosa_heads(sparsity) == heads
    assert {k: dataclasses.astuple(v) for k, v in tflops.PAPER_MODELS.items()} \
        == {k: dataclasses.astuple(v) for k, v in jflops.PAPER_MODELS.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        get_config("no-such-arch")
