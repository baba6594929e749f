"""Batched serving driver (port of ``Server`` from ``repro.launch.serve``).

``Server(cfg, ...)`` holds a ``TransformerLM`` on one device (the card by
default) and serves whole batches: ``generate`` runs one prefill over the
prompts and then ``gen_len - 1`` decode steps, greedy by default.  With
``paged=PagedConfig(...)`` the dense heads keep their KV in block-paged
pools with identity block tables; the MoSA heads keep their O(k) streaming
cache.  Everything runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.nn.transformer import TransformerLM, sample_logits
from repro_torch.serve.paged_kv import PagedConfig


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raises when CUDA is absent rather than
    falling back to the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


class Server:
    def __init__(self, model_cfg, max_len: int = 256, batch: int = 4,
                 params: Optional[dict] = None,
                 paged: Optional[PagedConfig] = None, device=None,
                 seed: int = 0):
        """``params``: a ``state_dict`` for ``TransformerLM`` (e.g. from
        ``repro_torch.convert.params_from_jax``); ``None`` draws random
        weights from ``torch.Generator`` seeded with ``seed``."""
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.max_len = max_len
        self.batch = batch
        self.paged = paged
        with torch.no_grad():
            self.model = TransformerLM(model_cfg, device=self.device)
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                self.model.init(gen)
            else:
                self.model.load_state_dict(params)
        self.model.eval()

    def new_cache(self, batch: Optional[int] = None):
        batch = self.batch if batch is None else batch
        paged = self.paged if batch == self.batch else None
        return self.model.init_cache(batch, self.max_len, paged=paged,
                                     device=self.device)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor, gen_len: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 top_k: int = 0):
        """prompts: (B, P) integer -> ((B, gen_len) int64, caches).  One
        prefill, then ``gen_len - 1`` decode steps; greedy when
        ``temperature == 0``."""
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"batch {B} != server batch {self.batch}")
        if self.paged is not None and self.paged.num_blocks:
            raise ValueError("generate needs auto-sized paged pools "
                             "(identity block tables)")
        if P + gen_len - 1 > self.max_len:
            raise ValueError(f"prompt ({P}) + {gen_len - 1} decode steps "
                             f"exceeds max_len {self.max_len}")
        prompts = prompts.to(self.device)
        caches = self.new_cache()
        logits, caches = self.model.prefill(prompts, caches)
        tok0 = sample_logits(logits[:, -1], generator, temperature, top_k)
        toks, caches = self.model.decode_many(tok0[:, None], caches,
                                              generator, gen_len - 1,
                                              temperature, top_k)
        return torch.cat([tok0[:, None], toks], dim=1), caches

