"""Assigned input shapes (one set for all LM-family archs) + input specs
(port of ``repro.configs.shapes``).

``train_*`` shapes feed a training step, ``prefill_*`` the prefill forward,
``decode_*`` / ``long_*`` one decode step (one new token against a KV
cache of ``seq_len``).  ``input_specs`` gives the model inputs of one cell
as tensors on the ``meta`` device (shape and dtype, no storage), where the
JAX package gives ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg, shape: ShapeCfg) -> dict:
    """Meta-device stand-ins for the model inputs of one cell.

    For train/prefill:
      * token archs: {"tokens": (B, T) int32, "labels": (B, T) int32}
      * stub-frontend archs (audio/vlm): {"embeds": (B, T, h) in the
        compute dtype, "labels"} -- the modality frontend supplies
        precomputed frame/patch embeddings.
    For decode: {"token": (B, 1) int32} (the cache is threaded separately).
    """
    B, T = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": spec((B, 1), torch.int32)}
    specs = {"labels": spec((B, T), torch.int32)}
    if cfg.frontend in ("audio_stub", "vision_stub"):
        specs["embeds"] = spec((B, T, cfg.d_model), cfg.cdtype)
    else:
        specs["tokens"] = spec((B, T), torch.int32)
    return specs
