"""Resumable, sharded LM data pipeline (the port's own copy of
``repro.data.pipeline``: numpy only, byte-identical batches).

The corpus source is a deterministic synthetic
generator (``SyntheticCorpus``) with realistic statistics: zipfian unigram
distribution + a Markov backbone + copy/recall spans (the structure MoSA's
router can exploit, mirroring why content-based sparsity wins on C4).  The
pipeline itself is source-agnostic — any iterator of token id arrays works.

Production features:
  * **determinism & resume**: the stream is a pure function of
    (seed, step) — checkpointing just the step counter resumes bit-exactly;
  * **host sharding**: each data-parallel host takes its slice of the global
    batch (``shard_index / shard_count``);
  * **packing**: documents are packed into fixed (B, T+1) blocks, split into
    inputs/labels;
  * **background prefetch**: a bounded queue on a producer thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    """Deterministic document stream with zipf + markov + recall structure."""

    vocab: int = 8000
    seed: int = 0
    mean_doc_len: int = 512
    copy_frac: float = 0.15   # fraction of a doc that repeats an earlier span

    def doc(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, index]))
        n = max(16, int(rng.exponential(self.mean_doc_len)))
        n = min(n, 4 * self.mean_doc_len)
        # zipfian unigrams over the vocab (reserve 0 for padding/bos)
        ranks = rng.zipf(1.3, size=n)
        toks = (ranks % (self.vocab - 2)) + 2
        # markov smoothing: with p=0.3, next token = f(prev) (bigram structure)
        follow = (np.arange(self.vocab) * 2654435761 % (self.vocab - 2)) + 2
        chain = rng.random(n) < 0.3
        toks[1:] = np.where(chain[1:], follow[toks[:-1]], toks[1:])
        # recall spans: copy an earlier chunk verbatim (needle structure)
        if n > 64 and self.copy_frac > 0:
            span = max(8, int(n * self.copy_frac / 2))
            src = rng.integers(0, n - 2 * span)
            dst = rng.integers(src + span, n - span)
            toks[dst:dst + span] = toks[src:src + span]
        toks[0] = 1  # BOS
        return toks.astype(np.int32)


@dataclasses.dataclass
class PackedLMDataset:
    """Packs documents into (B, T+1) blocks -> {"tokens", "labels"}.

    ``segmented=True`` additionally emits per-token document metadata so the
    model can mask cross-document attention (TransformerLM.loss threads it
    to every attention mixer):

      * ``"segments"``  (B, T) int32 — document id of each input token
        (ids are distinct per document within a row; a document spanning a
        row boundary keeps its id, which is harmless — rows never interact);
      * ``"positions"`` (B, T) int32 — LOCAL offset within the document, so
        RoPE restarts at every boundary;
      * boundary labels are masked to -1: the label of a document's last
        token is the next document's first token — an unlearnable target
        that polluted the loss in the unsegmented scheme.

    ``segmented=False`` (default) is byte-identical to the historical
    batches — existing training runs resume unchanged.
    """

    corpus: SyntheticCorpus
    seq_len: int
    global_batch: int
    shard_index: int = 0
    shard_count: int = 1
    segmented: bool = False

    def __post_init__(self):
        assert self.global_batch % self.shard_count == 0, \
            (self.global_batch, self.shard_count)
        self.local_batch = self.global_batch // self.shard_count

    def batch_at(self, step: int) -> dict:
        """Pure function of step — the resume guarantee."""
        B, T = self.local_batch, self.seq_len
        need = B * (T + 1)
        out = np.empty((need,), np.int32)
        seg = np.empty((need,), np.int32)
        pos = np.empty((need,), np.int32)
        filled = 0
        # each (step, shard, i) names its own document stream
        i = 0
        while filled < need:
            doc = self.corpus.doc(
                ((step * self.shard_count + self.shard_index) << 16) + i)
            take = min(len(doc), need - filled)
            out[filled:filled + take] = doc[:take]
            seg[filled:filled + take] = i
            pos[filled:filled + take] = np.arange(take, dtype=np.int32)
            filled += take
            i += 1
        blk = out.reshape(B, T + 1)
        if not self.segmented:
            return {"tokens": blk[:, :-1].copy(), "labels": blk[:, 1:].copy()}
        sb = seg.reshape(B, T + 1)
        pb = pos.reshape(B, T + 1)
        labels = blk[:, 1:].copy()
        labels[sb[:, 1:] != sb[:, :-1]] = -1     # cross-doc target: masked
        return {"tokens": blk[:, :-1].copy(), "labels": labels,
                "segments": sb[:, :-1].copy(),
                "positions": pb[:, :-1].copy()}

    def iter_from(self, step: int) -> Iterator[dict]:
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch over any step-indexed dataset."""

    def __init__(self, dataset, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


class ByteTokenizer:
    """Byte-level tokenizer with a small word cache — offline-friendly stand-in
    for SentencePiece (ids 0=pad, 1=bos, 2..257=bytes, 258+=cached words)."""

    def __init__(self, vocab: int = 8000):
        self.vocab = vocab
        self._word_to_id: dict = {}
        self._id_to_word: dict = {}

    def encode(self, text: str) -> np.ndarray:
        ids = [1]
        for word in text.split(" "):
            wid = self._word_to_id.get(word)
            if wid is None and 258 + len(self._word_to_id) < self.vocab:
                wid = 258 + len(self._word_to_id)
                self._word_to_id[word] = wid
                self._id_to_word[wid] = word
            if wid is not None:
                ids.append(wid)
            else:
                ids.extend(2 + b for b in word.encode("utf-8"))
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        words, buf = [], bytearray()
        for t in np.asarray(ids).tolist():
            if t >= 258:
                if buf:
                    words.append(buf.decode("utf-8", "replace"))
                    buf = bytearray()
                words.append(self._id_to_word.get(t, "<unk>"))
            elif t >= 2:
                buf.append(t - 2)
        if buf:
            words.append(buf.decode("utf-8", "replace"))
        return " ".join(words)
