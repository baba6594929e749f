"""Weights and train state between the JAX package and the port.

``params_from_jax(cfg, params)`` takes the JAX parameter tree of a
``repro.nn.transformer.TransformerLM`` as nested dicts of numpy arrays and
returns the ``state_dict`` of ``repro_torch.nn.transformer.TransformerLM``;
``params_to_jax`` is its inverse.  ``train_state_from_jax`` /
``train_state_to_jax`` do the same for a whole train state
``{"params": ..., "opt": {"mu": ..., "nu": ...}}`` (the AdamW moments have
the parameters' tree), which is what a checkpoint holds.  The port keeps
the JAX parameter names (the gated hybrid's ``mixer.gate`` included), so
a leaf path maps to a state-dict key by joining with ``.``; only the
layer stacking differs:

  * scanned layers live in ``params["layers"]["scan"]["pos{j}"]`` with a
    leading unit axis — unit ``u``, position ``j`` is layer
    ``head + u * p + j`` (``find_period``);
  * unrolled layers live in ``params["layers"]["tail"]["layer{i}"]``.

The port imports no JAX: the caller converts device arrays to numpy first
(``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.nn.transformer import find_period


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no native bf16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree, prefix, out, transform=lambda a: a):
    for name, sub in tree.items():
        key = f"{prefix}.{name}" if prefix else name
        if isinstance(sub, dict):
            _flatten(sub, key, out, transform)
        else:
            out[key] = _tensor(transform(sub))


def params_from_jax(cfg, params) -> dict:
    """JAX ``TransformerLM`` params (numpy leaves) -> the port's state_dict."""
    out: dict = {}
    pattern = cfg.resolved_pattern()
    head, p, units, tail_start = (find_period(pattern) if cfg.scan_layers
                                  else (0, 0, 0, 0))
    for name, sub in params.items():
        if name != "layers":
            _flatten({name: sub}, "", out)
    layers = params["layers"]
    for j in range(p):
        stacked = layers["scan"][f"pos{j}"]
        for u in range(units):
            _flatten(stacked, f"layers.{head + u * p + j}", out,
                     lambda a, u=u: np.asarray(a)[u])
    for key, sub in layers.get("tail", {}).items():
        _flatten(sub, f"layers.{int(key[len('layer'):])}", out)
    return out


def params_to_jax(cfg, state_dict) -> dict:
    """The port's ``state_dict`` (or any dict keyed like it, such as an
    AdamW moment) -> the JAX parameter tree, nested dicts of numpy arrays."""
    pattern = cfg.resolved_pattern()
    head, p, units, tail_start = (find_period(pattern) if cfg.scan_layers
                                  else (0, 0, 0, 0))
    out: dict = {}
    stacked: dict = {}                   # (j, leaf path) -> {unit: array}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
        parts = key.split(".")
        if parts[0] != "layers":
            _put(out, parts, np.asarray(arr))
            continue
        i, rest = int(parts[1]), tuple(parts[2:])
        if head <= i < tail_start:
            u, j = divmod(i - head, p)
            stacked.setdefault((j, rest), {})[u] = np.asarray(arr)
        else:
            _put(out, ["layers", "tail", f"layer{i}", *rest], np.asarray(arr))
    for (j, rest), by_unit in stacked.items():
        _put(out, ["layers", "scan", f"pos{j}", *rest],
             np.stack([by_unit[u] for u in range(units)]))
    return out


def _put(tree, path, leaf):
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = leaf


def train_state_to_jax(cfg, params, opt_state) -> dict:
    """(params, AdamW state ``{"mu", "nu"}``) -> the JAX train-state tree
    ``{"params", "opt": {"mu", "nu"}}`` of numpy arrays."""
    return {"params": params_to_jax(cfg, params),
            "opt": {m: params_to_jax(cfg, opt_state[m]) for m in ("mu", "nu")}}


def train_state_from_jax(cfg, tree) -> tuple[dict, dict]:
    """The JAX train-state tree -> (state_dict, AdamW state with the same
    keys)."""
    return (params_from_jax(cfg, tree["params"]),
            {m: params_from_jax(cfg, tree["opt"][m]) for m in ("mu", "nu")})
