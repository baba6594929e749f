"""The dense GQA architectures of the port (ROADMAP A.9a, A.9b) against the
JAX package, on the CPU: ``qwen2-1.5b``, ``yi-9b``, ``yi-34b``,
``musicgen-large`` (an audio-stub frontend: the model reads frame
embeddings) and ``gemma3-4b`` (a 5:1 local:global pattern, d_head 256, the
embedding scaled by sqrt(d_model)), each at its smoke preset in fp32, and
``with_mosa(sparsity=4, n_mosa_heads=4)`` of yi-9b, qwen2-1.5b and
gemma3-4b (the JAX package's ``tests/test_archs_smoke.py`` variants).

Weights are seeded numpy values fed to both packages (``params_from_jax``);
the JAX oracles are jitted.  Tolerances: logits ``MODEL_TOL`` (1e-4 after a
stack of fp32 layers whose matmuls sum in different orders), the loss 1e-5
relative (a mean over every token, so the per-logit noise averages down),
greedy tokens exactly.  Also: one full-width, 2-layer, vocab-512 stack of
gemma3-4b (d_head 256, one local and one global layer) against JAX;
``with_mosa``'s rename, default heads and refusal of an attention-free
pattern; ``input_specs`` and ``cache_nbytes`` against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import shapes as jshapes
from repro.core.kv_cache import cache_nbytes as jax_cache_nbytes
from repro.launch.serve import Server
from repro.nn.transformer import TransformerLM as JLM
from repro.serve.paged_kv import PagedConfig

from repro_torch.configs import base as tbase
from repro_torch.configs import shapes as tshapes
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.kv_cache import cache_nbytes
from repro_torch.launch.serve import Server as TServer
from repro_torch.nn.transformer import TransformerLM
from repro_torch.serve.paged_kv import PagedConfig as TPagedConfig

from test_torch_parity import (MODEL_TOL, n, numpy_params, one_cpu_thread,  # noqa: F401
                               to_jax, torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")

ARCHS = ["qwen2-1.5b", "yi-9b", "yi-34b", "musicgen-large", "gemma3-4b"]
MOSA_ARCHS = ["yi-9b", "qwen2-1.5b", "gemma3-4b"]
VARIANTS = [(a, False) for a in ARCHS] + [(a, True) for a in MOSA_ARCHS]
B, T, G, MAX_LEN = 2, 24, 8, 64
LOSS_RTOL = 1e-5


def _cfg(arch, mosa, get=jbase.get_config):
    cfg = get(arch, preset="smoke")
    return cfg.with_mosa(sparsity=4, n_mosa_heads=4) if mosa else cfg


_MODELS: dict = {}


def _models(arch, mosa):
    """(JAX config, jitted JAX forward and loss, numpy params, the port's
    model with the same weights), built once per variant."""
    key = (arch, mosa)
    if key not in _MODELS:
        cfg = _cfg(arch, mosa)
        jm = JLM(cfg)
        params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                              seed=7)
        model = TransformerLM(torch_config(cfg))
        model.load_state_dict(params_from_jax(cfg, params))
        fwd = jax.jit(lambda p, t, e: jm(p, t, inputs_embeds=e)[0])
        loss = jax.jit(lambda p, b: jm.loss(p, b)[0])
        _MODELS[key] = (cfg, fwd, loss, params, model)
    return _MODELS[key]


def _batch(cfg, seed=3, Tn=32):
    """Token ids, or (stub frontends) frame embeddings, and labels, from
    numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (B, Tn + 1), dtype=np.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.frontend in ("audio_stub", "vision_stub"):
        batch["embeds"] = (0.02 * rng.standard_normal(
            (B, Tn, cfg.d_model))).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :-1]
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_configs_match_jax(arch, preset):
    """Every registered config, and its with_mosa variant, field by field
    (``impl`` mapped pallas <-> kernel)."""
    ours = tbase.get_config(arch, preset=preset)
    theirs = jbase.get_config(arch, preset=preset)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.with_mosa()) == \
        dataclasses.asdict(theirs.with_mosa())
    assert dataclasses.asdict(torch_config(theirs)) == \
        dataclasses.asdict(ours)


def test_every_ported_arch_is_registered():
    assert set(ARCHS) | {"mosa-paper"} == set(tbase.config_names())


@pytest.mark.parametrize("arch", ARCHS)
def test_with_mosa_rename_and_default_heads(arch):
    """``<name>-mosa<sparsity>``, the FLOP-matched default head count
    ``max(1, n_heads - 4) * sparsity // 2`` beside 4 dense heads of the
    config's d_head, every attention mixer a ``mosa`` mixer; as JAX's."""
    cfg = tbase.get_config(arch)
    for sparsity in (8, 32):
        m = cfg.with_mosa(sparsity=sparsity)
        j = jbase.get_config(arch).with_mosa(sparsity=sparsity)
        assert m.name == f"{cfg.name}-mosa{sparsity}" == j.name
        assert m.mosa.n_mosa_heads == \
            max(1, cfg.attention.n_heads - 4) * sparsity // 2 == \
            j.mosa.n_mosa_heads
        assert (m.mosa.n_dense_heads, m.mosa.d_head) == \
            (4, cfg.attention.d_head)
        assert {b.mixer for b in m.resolved_pattern()} == {"mosa"}


def test_with_mosa_refuses_an_attention_free_pattern():
    cfg = dataclasses.replace(
        tbase.get_config("yi-9b", preset="smoke"),
        pattern=(tbase.BlockSpec("mamba", "dense"),) * 2)
    with pytest.raises(ValueError, match="inapplicable"):
        cfg.with_mosa()


def test_gemma_embedding_scale_keeps_its_name_prefix():
    """The sqrt(d_model) scale applies to the gemma family by name, so the
    with_mosa rename (gemma3-...-mosa4) keeps it; other archs embed
    unscaled."""
    for arch, mosa, scaled in (("gemma3-4b", False, True),
                               ("gemma3-4b", True, True),
                               ("yi-9b", False, False)):
        model = _models(arch, mosa)[-1]
        tok = torch.tensor([[5, 9]])
        want = model.embed(tok) * (model.cfg.d_model ** 0.5 if scaled else 1)
        torch.testing.assert_close(model._embed_tokens(tok), want)


@pytest.mark.parametrize("arch,mosa", VARIANTS)
def test_forward_and_loss_match_jax(arch, mosa):
    """Forward logits (B, 32, vocab) and the masked next-token loss, from
    tokens or (musicgen) from a batch's ``"embeds"``."""
    cfg, fwd, loss, params, model = _models(arch, mosa)
    batch = _batch(cfg)
    jp = to_jax(params)
    want = fwd(jp, batch.get("tokens"), batch.get("embeds"))
    tb = _torch_batch(batch)
    with torch.no_grad():
        got, _ = model(tb.get("tokens"), inputs_embeds=tb.get("embeds"))
        tloss, metrics = model.loss(tb)
    assert got.shape == (B, 32, cfg.vocab)
    np.testing.assert_allclose(n(got), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(tloss), float(loss(jp, batch)),
                               rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == B * 32


@pytest.mark.parametrize("arch,mosa", VARIANTS)
def test_greedy_generate_matches_jax_server(arch, mosa):
    """Prefill + 8 greedy decode tokens through ``Server.generate``, on
    contiguous caches and (port) on paged ones, equal the JAX Server's
    (gemma3's 24-token prompts wrap its window-16 rings)."""
    cfg, _, _, params, _ = _models(arch, mosa)
    prompts = np.random.default_rng(11).integers(2, cfg.vocab, (B, T),
                                                 dtype=np.int32)
    jsrv = Server(cfg, batch=B, max_len=MAX_LEN, params=to_jax(params))
    want, _ = jsrv.generate(jnp.asarray(prompts), G)
    sd = params_from_jax(cfg, params)
    for paged in (None, TPagedConfig(block_size=16)):
        tsrv = TServer(torch_config(cfg), batch=B, max_len=MAX_LEN,
                       params=sd, paged=paged, device="cpu")
        got, _ = tsrv.generate(torch.from_numpy(prompts), G)
        np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("arch,mosa", VARIANTS)
def test_params_round_trip(arch, mosa):
    """``params_to_jax(params_from_jax(p)) == p`` leaf for leaf: QKV and
    LayerNorm biases, tied embeddings (no unembed), gemma3's 5:1 pattern
    split by ``find_period``."""
    cfg, _, _, params, model = _models(arch, mosa)
    back = params_to_jax(cfg, model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    a, b = dict(flat(params)[0]), dict(flat(back)[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert (model.unembed is None) == cfg.tie_embeddings


def test_gemma_full_width_two_layers_match_jax():
    """gemma3-4b at full width (d_model 2560, 8 heads of 256 over 4 KV
    heads, d_ff 10240) cut to 2 layers (one local, one global) and a
    vocabulary of 512, fp32: logits and loss against JAX on the plain
    versions (the port's attention at d 256 on CPU tensors)."""
    full = jbase.get_config("gemma3-4b", preset="full")
    cfg = dataclasses.replace(full, n_layers=2, vocab=512,
                              pattern=full.pattern[4:6],
                              param_dtype="float32", compute_dtype="float32")
    assert [b.mixer for b in cfg.pattern] == ["attn_local", "attn"]
    jm = JLM(cfg)
    params = numpy_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                          seed=5)
    model = TransformerLM(torch_config(cfg))
    model.load_state_dict(params_from_jax(cfg, params))
    batch = _batch(cfg, Tn=16)
    jp = to_jax(params)
    want = jax.jit(lambda p, t: jm(p, t)[0])(jp, batch["tokens"])
    with torch.no_grad():
        got, _ = model(_torch_batch(batch)["tokens"])
        tloss, _ = model.loss(_torch_batch(batch))
    assert model.layers[0].mixer.cfg.d_head == 256
    np.testing.assert_allclose(n(got), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(tloss), float(jm.loss(jp, batch)[0]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", sorted(tshapes.SHAPES))
def test_input_specs_match_jax(arch, shape):
    """The same keys, shapes and dtypes as JAX's ShapeDtypeStructs (meta
    tensors, no storage): "embeds" for the stub frontend, "tokens" else."""
    cfg = tbase.get_config(arch)
    ours = tshapes.input_specs(cfg, tshapes.SHAPES[shape])
    theirs = jshapes.input_specs(jbase.get_config(arch), jshapes.SHAPES[shape])
    assert ours.keys() == theirs.keys()
    for k, t in ours.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(theirs[k].shape)
        assert str(t.dtype).split(".")[-1] == str(theirs[k].dtype)
    if tshapes.SHAPES[shape].kind != "decode":
        assert ("embeds" in ours) == (cfg.frontend == "audio_stub")
    assert dataclasses.astuple(tshapes.SHAPES[shape]) == \
        dataclasses.astuple(jshapes.SHAPES[shape])


@pytest.mark.parametrize("arch,mosa", VARIANTS)
def test_cache_nbytes_matches_jax(arch, mosa):
    """The serving caches' bytes, contiguous and paged, as JAX counts its
    cache pytrees, but for the MoSA caches' ``idx``: int64 in the port
    (torch's index dtype), int32 in JAX, 4 bytes more per slot."""
    cfg, _, _, params, _ = _models(arch, mosa)
    sd = params_from_jax(cfg, params)
    for jpaged, tpaged in ((None, None),
                           (PagedConfig(block_size=16),
                            TPagedConfig(block_size=16))):
        jsrv = Server(cfg, batch=B, max_len=MAX_LEN, params=to_jax(params),
                      paged=jpaged)
        tsrv = TServer(torch_config(cfg), batch=B, max_len=MAX_LEN,
                       params=sd, paged=tpaged, device="cpu")
        caches = tsrv.new_cache()
        wider = sum(4 * c["sparse"].idx.numel() for c in caches
                    if isinstance(c, dict))
        assert (wider > 0) == mosa
        assert cache_nbytes(caches) == \
            jax_cache_nbytes(jsrv.new_cache()) + wider > 0
