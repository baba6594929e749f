"""Weights from the JAX package to the port.

``params_from_jax(cfg, params)`` takes the JAX parameter tree of a
``repro.nn.transformer.TransformerLM`` as nested dicts of numpy arrays and
returns the ``state_dict`` of ``repro_torch.nn.transformer.TransformerLM``.
The port keeps the JAX parameter names, so a leaf path maps to a state-dict
key by joining with ``.``; only the layer stacking differs:

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
