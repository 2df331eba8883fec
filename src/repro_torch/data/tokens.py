"""Synthetic LM token pipeline: sharded, deterministic, checkpointable.

The port's own copy of :mod:`repro.data.tokens` (numpy only): for the
same ``seed``, ``host_index`` and batch index it gives the reference's
batches bit for bit, and ``state()`` / ``from_state`` resume exactly.

Serves the role of a real corpus loader in this framework:

* **Deterministic + seekable** — batch ``i`` is a pure function of
  (seed, i), so restart-from-checkpoint replays exactly (the
  CheckpointManager stores ``state()``).
* **Sharded** — each data-parallel host generates only its slice
  (``host_index`` / ``host_count``), the way a distributed loader
  shards files.
* **Structured** — tokens follow a Zipfian unigram distribution mixed
  with short-range Markov structure, so language models actually have
  something learnable (the train-loss curve of examples/train_lm.py is
  meaningful, unlike uniform noise).
* **Prefetched** — a background thread keeps a small queue of ready
  batches (host-side compute/IO overlap).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    def __init__(
        self,
        *,
        vocab: int,
        seq_len: int,
        batch_size: int,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        start_batch: int = 0,
        zipf_a: float = 1.2,
        markov_order: int = 1,
        prefetch: int = 2,
    ):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.index = start_batch
        self.markov_order = markov_order

        # Zipf unigram over the vocab
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self._unigram = ranks ** (-zipf_a)
        self._unigram /= self._unigram.sum()
        # deterministic "grammar": next-token shift pattern
        g = np.random.default_rng(seed ^ 0x5EED)
        self._shift = g.integers(1, vocab, size=997)

        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # --------------------------------------------------------------- batches
    def _gen(self, index: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + index) * 31 + self.host_index)
        b, s = self.batch_size, self.seq_len
        base = rng.choice(self.vocab, size=(b, s + 1), p=self._unigram)
        # Markov structure: with p=0.5 the next token is a deterministic
        # function of the previous one (learnable signal)
        follow = rng.uniform(size=(b, s)) < 0.5
        nxt = (base[:, :-1] + self._shift[base[:, :-1] % 997]) % self.vocab
        seq = base.copy()
        seq[:, 1:] = np.where(follow, nxt, base[:, 1:])
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "targets": seq[:, 1:].astype(np.int32),
        }

    def _producer(self):
        idx = self.index
        while not self._stop.is_set():
            batch = self._gen(idx)
            while not self._stop.is_set():
                try:
                    self._queue.put((idx, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            idx += 1

    def __next__(self) -> dict:
        idx, batch = self._queue.get()
        self.index = idx + 1
        return batch

    def __iter__(self):
        return self

    # ------------------------------------------------------------ state
    def state(self) -> dict:
        return {
            "index": self.index,
            "seed": self.seed,
            "host_index": self.host_index,
            "host_count": self.host_count,
        }

    def close(self):
        self._stop.set()

    @classmethod
    def from_state(cls, state: dict, **kw) -> "SyntheticTokens":
        return cls(
            seed=state["seed"],
            host_index=state["host_index"],
            host_count=state["host_count"],
            start_batch=state["index"],
            **kw,
        )
