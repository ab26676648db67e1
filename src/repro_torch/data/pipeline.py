"""Synthetic token pipeline: deterministic and double-buffered (port of
``repro/data/pipeline.py`` for one device).

  * **Deterministic seek** — ``batch_at(step)`` is a pure numpy function
    of (seed, step), the reference's own draws, so the port's batches
    equal the reference's bit for bit and a restarted job resumes with
    the same batches.
  * **Double-buffered prefetch** — a background thread keeps ``depth``
    batches in flight and moves each to the device there, so the copy
    overlaps the training step (the reference's sharded placement has no
    counterpart on one device).

The synthetic distribution is a mixture of Zipf-ish unigram draws and
shifted-copy spans, enough structure for the loss to move.  Only the
token stream is ported (the reference's audio-frame and vision-patch
frontends: ROADMAP A11).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


class SyntheticLM:
    """Deterministic synthetic LM token stream."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 *, seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        # Zipf-ish unigram table, fixed by seed.
        r = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()
        self._perm = r.permutation(vocab)

    def _tokens_at(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch for ``step`` (pure)."""
        out = np.empty((hi - lo, self.seq_len), np.int32)
        for i, row in enumerate(range(lo, hi)):
            r = np.random.default_rng(
                (self.seed * 1_000_003 + step) * 131_071 + row)
            toks = self._perm[
                r.choice(self.vocab, self.seq_len, p=self._p)]
            # splice in a shifted-copy span (learnable structure)
            span = self.seq_len // 4
            if span >= 2:
                start = int(r.integers(0, self.seq_len - 2 * span + 1))
                toks[start + span: start + 2 * span] = \
                    toks[start: start + span]
            out[i] = toks
        return out

    def batch_at(self, step: int) -> dict:
        """The full batch for ``step``: int32 host tensors."""
        tokens = self._tokens_at(step, 0, self.global_batch)
        # Next-token labels: labels[i] = tokens[i + 1]; the last column 0.
        labels = np.concatenate(
            [tokens[:, 1:], np.zeros_like(tokens[:, :1])], axis=1)
        return {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)}


class Prefetcher:
    """Background-thread double buffering of ``dataset.batch_at(step)``,
    each batch moved to ``device`` on the thread.

    ``depth=2`` is the paper's double-buffer; ``depth=3`` its 3-slot
    rotation.  ``get(step)`` returns batches strictly in order, and
    raises what the thread raised if building or moving a batch failed.
    """

    def __init__(self, dataset: SyntheticLM, *, start_step: int = 0,
                 depth: int = 2, device=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            try:
                batch = {k: v.to(self.device)
                         for k, v in self.dataset.batch_at(step).items()}
            except Exception as e:   # handed to the consumer by get()
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return
            step += 1

    def get(self, expect_step: int = None) -> dict:
        step, batch = self._q.get()
        if isinstance(batch, Exception):
            raise RuntimeError(f"prefetcher failed at step {step}") from batch
        if expect_step is not None and step != expect_step:
            raise RuntimeError(
                f"prefetcher out of sync: got {step}, want {expect_step}")
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_pipeline(cfg, shape, *, seed: int = 0, start_step: int = 0,
                  depth: int = 2, device=None) -> Prefetcher:
    """Pipeline for one (arch, shape) cell (matches ``input_specs``)."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} pipelines are not ported yet (ROADMAP "
            f"A11)")
    ds = SyntheticLM(cfg.vocab, shape.seq_len, shape.global_batch,
                     seed=seed)
    return Prefetcher(ds, start_step=start_step, depth=depth, device=device)
