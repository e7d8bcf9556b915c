"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

A request queue (ring FIFO) feeds B *slots*; every tick decodes all live
slots in one ``lm.decode_step`` with **per-slot positions** (each sequence at
its own offset: a ``(B,)`` position vector).  When a slot finishes (EOS,
length budget or a full cache) it is retired and refilled from the queue at
the next tick, so compute never drains to a single straggler sequence.

Prefill runs per request at admission and its cache is spliced into the
slot.  The cache lives on the engine's device for its whole life and is
updated in place; per tick only the slots' tokens and positions go to the
card and only the sampled tokens come back.  The engine is synchronous:
``run()`` drives it to quiescence.

``device=None`` means ``cuda:0`` and raises without CUDA; the parameters must
lie on the engine's device.  ``device="cpu"`` runs on the CPU with the
kernels' plain versions (the tests do).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.model import lm
from repro_torch.model.layers import resolve_device
from repro_torch.pytree import tree_leaves
from repro_torch.runtime.fifo import RingFifo


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S_p,) int32
    max_new: int
    eos_id: int = 2
    # filled on completion:
    output: Optional[List[int]] = None


class ServingEngine:
    def __init__(
        self,
        cfg,
        params,
        *,
        slots: int = 4,
        max_len: int = 256,
        queue_depth: int = 64,
        device: Union[None, str, torch.device] = None,
    ):
        if cfg.frontend != "none":
            raise ValueError("ServingEngine serves token-in archs (cfg.frontend == 'none')")
        self.device = resolve_device(device, "ServingEngine")
        for leaf in tree_leaves(params):
            if leaf.device != self.device:
                raise ValueError(
                    f"ServingEngine: parameters lie on {leaf.device}, the engine on "
                    f"{self.device}"
                )
        self.cfg = cfg
        self.params = params
        self.B = slots
        self.max_len = max_len
        self.queue = RingFifo(queue_depth, name="requests", deferred=False)
        self.cache = lm.init_cache(cfg, slots, max_len, self.device)
        self.pos = np.zeros((slots,), np.int32)  # next write position per slot
        self.budget = np.zeros((slots,), np.int32)
        self.live: List[Optional[Request]] = [None] * slots
        self.tok = np.zeros((slots,), np.int32)
        self.done: List[Request] = []
        self.steps = 0
        self._decode = make_decode_step(cfg)
        self._prefill = make_prefill_step(cfg)

    # ---- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.write([req])

    def _splice_slot(self, slot: int, small_cache) -> None:
        """Copy a (layers, 1, ...) prefill cache into slot ``slot``.  Leaves
        indexed by sequence (attention K/V: dim 2 differs) are zero-padded to
        ``max_len``; the SSM leaves (state, conv windows) match as they are."""
        with torch.inference_mode():
            for key, leaves in small_cache.items():
                for name, small in leaves.items():
                    dst = self.cache[key][name][:, slot]
                    src = small[:, 0]
                    if dst.dim() >= 2 and src.shape[1] != dst.shape[1]:
                        dst.zero_()
                        dst = dst[:, :src.shape[1]]
                    dst.copy_(src)

    def _admit(self) -> None:
        for b in range(self.B):
            if self.live[b] is not None or self.queue.count() == 0:
                continue
            (req,) = self.queue.read(1)
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)
            logits, small = self._prefill(self.params, {"tokens": prompt[None, :]})
            self._splice_slot(b, small)
            first = int(torch.argmax(logits[0]))
            self.live[b] = req
            req.output = [first]
            self.pos[b] = prompt.shape[0]
            self.budget[b] = req.max_new - 1
            self.tok[b] = first
            if first == req.eos_id or self.budget[b] <= 0:
                self._retire(b)

    def _retire(self, b: int) -> None:
        req = self.live[b]
        self.live[b] = None
        self.done.append(req)

    # ---- the decode tick ------------------------------------------------------
    def step(self) -> int:
        """One engine tick: admit, decode all live slots, retire finished."""
        self._admit()
        active = [b for b in range(self.B) if self.live[b] is not None]
        if not active:
            return 0
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.as_tensor(self.tok, device=self.device),
            torch.as_tensor(self.pos, device=self.device),
        )
        nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        self.steps += 1
        for b in active:
            self.pos[b] += 1
            self.budget[b] -= 1
            tok = int(nxt[b])
            self.live[b].output.append(tok)
            self.tok[b] = tok
            if (
                tok == self.live[b].eos_id
                or self.budget[b] <= 0
                or self.pos[b] >= self.max_len - 1
            ):
                self._retire(b)
        return len(active)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive to quiescence: no live slots and an empty queue."""
        for _ in range(max_ticks):
            moved = self.step()
            if moved == 0 and self.queue.count() == 0:
                break
        return self.done
