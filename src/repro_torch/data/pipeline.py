"""Host data pipeline built on the paper's actor runtime.

The pipeline is a dataflow graph of host actors — sample generator → sequence
packer → batcher — feeding a prefetch ring FIFO drained by the training loop
(the input-stage actor of Fig. 6).  It runs on its own scheduler thread so data
preparation overlaps device compute, and it is *deterministically resumable*:
the generator state is (seed, cursor), and ``state_dict``/``load_state_dict``
round-trip through checkpoints so a restarted run replays the exact stream.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional


import numpy as np

from repro_torch.core.actor import Actor

from repro_torch.runtime.fifo import RingFifo


@dataclass
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    kind: str = "synthetic"  # synthetic | text
    text: Optional[str] = None
    embed_dim: int = 0  # >0: emit frontend embeddings instead of tokens


class SyntheticLM:
    """Deterministic synthetic LM stream: order-2 markov-ish integer process.

    Learnable (non-uniform transitions) so loss decreases; fully determined by
    (seed, cursor) — the resumability contract.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.cursor = 0

    def _row(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + idx)
        V = cfg.vocab_size
        x = np.empty((cfg.seq_len + 1,), np.int64)
        x[0] = rng.integers(0, V)
        noise = rng.random(cfg.seq_len)
        rand = rng.integers(0, V, cfg.seq_len)
        for t in range(1, cfg.seq_len + 1):
            base = (x[t - 1] * 31 + 17) % V
            # 85% deterministic successor, 15% noise -> learnable structure
            x[t] = base if noise[t - 1] < 0.85 else rand[t - 1]
        return x

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = [self._row(self.cursor + i) for i in range(cfg.global_batch)]
        self.cursor += cfg.global_batch
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}

    def state_dict(self) -> Dict[str, int]:
        return {"cursor": self.cursor, "seed": self.cfg.seed}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        assert d["seed"] == self.cfg.seed, "resume with a different data seed"
        self.cursor = int(d["cursor"])


class TextLM(SyntheticLM):
    """Byte-tokenized text stream over a fixed corpus (quickstart)."""

    def __init__(self, cfg: DataConfig):
        super().__init__(cfg)
        from repro_torch.data.tokenizer import encode

        ids = np.asarray(encode(cfg.text or ""), np.int32)
        reps = max(1, (cfg.seq_len * 4) // max(len(ids), 1) + 1)
        self.ids = np.tile(ids, reps)

    def _row(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        start = (idx * 97) % max(len(self.ids) - cfg.seq_len - 1, 1)
        return self.ids[start : start + cfg.seq_len + 1].astype(np.int64)


class DataPipeline:
    """Actor-graph data pipeline with a prefetch FIFO.

    gen (source) -> batch (sdf) -> [prefetch FIFO] drained by get_batch().
    """

    def __init__(self, cfg: DataConfig, prefetch: int = 4):
        self.cfg = cfg
        self.stream = (
            TextLM(cfg) if cfg.kind == "text" else SyntheticLM(cfg)
        )
        # immediate-publication mode: there is no scheduler round to publish in,
        # and SPSC counter stores are atomic under the GIL (conservative views)
        self.fifo = RingFifo(prefetch, name="prefetch", deferred=False)
        self._stop = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._started = False
        self._lock = threading.Condition()

    # -- producer thread (the "input stage" actor) ---------------------------
    def _producer(self):
        while not self._stop:
            if self.fifo.space() >= 1:
                batch = self.stream.next_batch()
                if self.cfg.embed_dim:
                    toks = batch.pop("tokens")
                    rng = np.random.default_rng(int(toks[0, 0]) + 1)
                    batch["embeds"] = rng.standard_normal(
                        (toks.shape[0], toks.shape[1], self.cfg.embed_dim)
                    ).astype(np.float32)
                self.fifo.write([batch])
                with self._lock:
                    self._lock.notify_all()
            else:
                with self._lock:
                    self._lock.wait(timeout=0.002)

    def start(self) -> "DataPipeline":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def get_batch(self, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        assert self._started, "call start() first"
        deadline = None
        import time as _t

        deadline = _t.monotonic() + timeout
        while self.fifo.count() < 1:
            with self._lock:
                self._lock.wait(timeout=0.002)
            assert _t.monotonic() < deadline, "data pipeline starved"
        (batch,) = self.fifo.read(1)
        with self._lock:
            self._lock.notify_all()
        return batch

    def stop(self):
        self._stop = True

    # -- resumability ------------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        # account for prefetched-but-unconsumed batches so replay is exact
        inflight = self.fifo.occupancy()
        st = self.stream.state_dict()
        st["cursor"] = st["cursor"] - inflight * self.cfg.global_batch
        return st

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self.stream.load_state_dict(d)
