"""The port's data pipeline, checkpoints, trainer and CLI, on the CPU.

  * ``PackedLMDataset.batch_at`` gives byte-identical batches to the JAX
    package's, in both modes;
  * a JAX ``checkpoint.save`` of params and AdamW state restores in the
    port, and one step from it matches one JAX step; a port checkpoint
    round-trips and restores in the JAX package too;
  * the ``Trainer`` (device "cpu", ``--mosa-impl kernel``) killed by a real
    SIGTERM resumes from its checkpoint and replays the loss curve of an
    uninterrupted run bit for bit;
  * the trainer and ``launch.train`` refuse to fall back to the CPU.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.nn.transformer import TransformerLM as JLM
from repro.optim import optimizer as jopt
from repro.optim import schedules as jsched
from repro.train.step import make_train_step as jmake_train_step

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data import pipeline as tpipe
from repro_torch.nn.transformer import TransformerLM
from repro_torch.optim import optimizer as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.step import make_train_step

from test_torch_parity import (numpy_params, one_cpu_thread,  # noqa: F401
                               torch_config)

pytestmark = pytest.mark.usefixtures("one_cpu_thread")


@pytest.mark.parametrize("segmented", [False, True])
def test_packed_batches_are_byte_identical(segmented):
    mk = [m.PackedLMDataset(m.SyntheticCorpus(vocab=8000, seed=3),
                            seq_len=96, global_batch=3, segmented=segmented)
          for m in (jpipe, tpipe)]
    for step in (0, 1, 7):
        want, got = (d.batch_at(step) for d in mk)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_prefetcher_and_tokenizer_match():
    ds = tpipe.PackedLMDataset(tpipe.SyntheticCorpus(vocab=512, seed=1),
                               seq_len=16, global_batch=2)
    pf = tpipe.Prefetcher(ds, start_step=5)
    try:
        for s in (5, 6):
            step, b = pf.next()
            assert step == s
            assert b["tokens"].tobytes() == ds.batch_at(s)["tokens"].tobytes()
    finally:
        pf.close()
    text = "the quick brown fox the end"
    assert (tpipe.ByteTokenizer(300).encode(text).tobytes()
            == jpipe.ByteTokenizer(300).encode(text).tobytes())


def _setup():
    jcfg = jget_config("mosa-paper", preset="smoke", variant="mosa")
    params = jax.tree.map(jnp.asarray, numpy_params(
        jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0)), 9))
    tok = np.random.default_rng(10).integers(2, 512, (2, 33)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    return jcfg, params, batch


def _opt(o, s):
    return o.adamw(s.linear_warmup(2.5e-4, 2), clip_norm=0.25)


def test_jax_checkpoint_restores_in_the_port_and_steps_alike(tmp_path):
    jcfg, params, batch = _setup()
    jstep = jax.jit(jmake_train_step(JLM(jcfg), _opt(jopt, jsched)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, o, s, _ = jstep(params, _opt(jopt, jsched).init(params),
                       jnp.zeros((), jnp.int32), jb)
    jckpt.save(str(tmp_path), 1, {"params": p, "opt": o},
               extra_meta={"step": 1})
    p2, o2, _, jm = jstep(p, o, s, jb)

    tree, extra = tckpt.restore(str(tmp_path))
    assert extra["step"] == 1
    state, opt = convert.train_state_from_jax(jcfg, tree)
    model = TransformerLM(torch_config(jcfg))
    model.load_state_dict(state)
    params_t = dict(model.named_parameters())
    params_t, opt, step, tm = make_train_step(model, _opt(topt, tsched))(
        params_t, opt, extra["step"], {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
    assert step == 2
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = convert.params_from_jax(jcfg, jax.tree.map(np.asarray, p2))
    for k, v in params_t.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_port_checkpoint_round_trips_and_restores_in_jax(tmp_path):
    jcfg, params, _ = _setup()
    model = TransformerLM(torch_config(jcfg))
    model.load_state_dict(convert.params_from_jax(
        jcfg, jax.tree.map(np.asarray, params)))
    params_t = dict(model.named_parameters())
    opt = _opt(topt, tsched).init(params_t)
    opt["mu"] = {k: torch.randn_like(v) for k, v in opt["mu"].items()}
    ck = tckpt.AsyncCheckpointer(str(tmp_path), keep_last=2)
    for step in (1, 2, 3):
        ck.save(step, convert.train_state_to_jax(jcfg, params_t, opt),
                extra_meta={"step": step})
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002",
                                            "step_0000000003"]
    tree, extra = tckpt.restore(str(tmp_path))
    state, opt2 = convert.train_state_from_jax(jcfg, tree)
    assert extra == {"step": 3}
    for k, v in params_t.items():
        assert torch.equal(state[k], v.detach())
        assert torch.equal(opt2["mu"][k], opt["mu"][k])
        assert torch.equal(opt2["nu"][k], opt["nu"][k])
    # the JAX package reads the port's checkpoint into its own tree
    target = {"params": params, "opt": _opt(jopt, jsched).init(params)}
    restored, jextra = jckpt.restore(str(tmp_path), target)
    assert jextra == {"step": 3}
    want = convert.train_state_to_jax(jcfg, params_t, opt)
    for (path, a) in jax.tree_util.tree_flatten_with_path(restored)[0]:
        node = want
        for part in path:
            node = node[part.key]
        np.testing.assert_array_equal(np.asarray(a), node)


def test_corrupt_checkpoint_is_refused(tmp_path):
    tckpt.save(str(tmp_path), 4, {"a": np.arange(5, dtype=np.float32)})
    path = tmp_path / "step_0000000004" / "arrays.npz"
    np.savez(path, a0=np.zeros(5, np.float32))
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(str(tmp_path))


def _cfg(ckpt_dir, steps):
    return TrainConfig(arch="mosa-paper", preset="smoke", seq_len=64,
                       global_batch=4, steps=steps, lr=1e-3, warmup=4,
                       ckpt_dir=str(ckpt_dir), ckpt_every=4, log_every=1,
                       arch_kwargs={"variant": "mosa"}, mosa_impl="kernel",
                       device="cpu")


def test_sigterm_resume_replays_loss_curve_bit_exact(tmp_path):
    N = 6
    _, _, hist_a = Trainer(_cfg(tmp_path / "solid", N)).run(
        install_signals=False)
    assert len(hist_a) == N

    tr_b = Trainer(_cfg(tmp_path / "killed", N))
    orig, calls = tr_b.train_step, {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **kw)

    tr_b.train_step = wrapped
    _, _, hist_b = tr_b.run()            # the handler catches the SIGTERM
    assert tckpt.latest_step(str(tmp_path / "killed")) == 3
    assert [h["step"] for h in hist_b] == [0, 1, 2]
    _, _, hist_c = Trainer(_cfg(tmp_path / "killed", N)).run(
        install_signals=False)
    assert [h["step"] for h in hist_c] == [3, 4, 5]
    assert ([h["loss"] for h in hist_b + hist_c]
            == [h["loss"] for h in hist_a])   # bit-exact, not allclose
    assert "sel_entropy" in hist_a[0]         # router health in the step


def test_trainer_and_cli_refuse_cpu_fallback(monkeypatch):
    from repro_torch.launch import train as launch_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(dataclasses.replace(_cfg(None, 1), device=None))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--preset", "smoke", "--variant", "mosa",
                           "--steps", "1"])


def test_cli_trains_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main(["--preset", "smoke", "--variant", "mosa", "--device",
                       "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
                       "--mosa-impl", "kernel", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and '"final"' in out
    # router health by a standalone forward at log time instead
    launch_train.main(["--preset", "smoke", "--variant", "mosa", "--device",
                       "cpu", "--steps", "1", "--batch", "2", "--seq", "32",
                       "--no-health-in-step"])
    assert " ent " in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="isoflop"):
        launch_train.main(["--isoflop", "--device", "cpu"])
