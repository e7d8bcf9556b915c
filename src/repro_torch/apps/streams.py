"""Benchmark actor networks (the paper's Table I workload suite, host-scale),
authored in the frontend DSL (``repro_torch.frontend``).

Every network is expressed once and can run on any partition — host threads,
the compiled device partition, or a mix — which is the point of the paper.
Actors that can run on the device carry a ``vector_fire``.

  * topfilter — the paper's Listing-1 network (guarded filter + priority)
  * fir       — N-tap systolic FIR pipeline (paper: 34 actors / 1D convolution)
  * bitonic8  — 8-lane bitonic sorting network of compare-exchange actors
                (paper: 28 actors / hardware sorting)
  * idct8     — 8-point IDCT actor network (paper: 7 actors)
  * zigzag    — JPEG zigzag descan, a 64-token SDF reorder (paper: the
                RVC-CAL JPEG decoder's zigzag stage)

Each ``<name>()`` builder returns ``(Network, collected_outputs)`` for use with
``repro_torch.compile``.  The ``make_<name>()`` constructors are thin shims over the
builders returning ``(ActorGraph, collected_outputs)`` — the seed's API — and
build graphs structurally identical to the seed's hand-wired ones (enforced by
tests/test_frontend.py against tests/seed_networks.py).

Port of ``repro/apps/streams.py``: the same networks and registries, with
every device ``vector_fire`` written in torch.  ``Idct.vector_fire`` sums its
8 terms in the fixed order the stream kernel uses (``kernels.stream_fused
.ref.matmul8``), so fused == unfused holds bitwise.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.graph import ActorGraph
from repro_torch.frontend import Network, action, actor, network
from repro_torch.kernels.stream_fused.ref import device_const, matmul8


def _lcg_source(net: Network, n: int, name: str = "source", mod: int = 100):
    def gen(st):
        x = st.get("x", 0)
        return {**st, "x": x + 1}, float((x * 1103515245 + 12345) % mod)

    return net.source(name, gen, has_next=lambda st: st.get("x", 0) < n)


# ---------------------------------------------------------------------------
# TopFilter — Listing 1: guarded keep/drop with CAL priority
# ---------------------------------------------------------------------------


@actor(inputs={"IN": "float32"}, outputs={"OUT": "float32"})
class Filter:
    """Keep tokens below ``param``; the keep action outranks the drop."""

    def __init__(self, param: float = 50.0):
        self.param = param

    @action(name="t0", consumes={"IN": 1}, produces={"OUT": 1},
            guard=lambda self, st, t: t["IN"][0] < self.param)
    def t0(self, st, t):
        return st, {"OUT": [t["IN"][0]]}

    @action(name="t1", consumes={"IN": 1})
    def t1(self, st, t):
        return st, {}

    def vector_fire(self, state, ins):
        vals, mask = ins["IN"]
        return state, {"OUT": (vals, mask & (vals < self.param))}


def topfilter(n: int = 4096, param: float = 50.0) -> Tuple[Network, List]:
    net = network("TopFilter")
    src = _lcg_source(net, n)
    filt = net.add(Filter(param), "filter")
    got: List = []
    snk = net.sink("sink", collect=got)
    src >> filt >> snk
    return net, got


# ---------------------------------------------------------------------------
# FIR — systolic pipeline of per-tap MAC actors
# ---------------------------------------------------------------------------


@actor(inputs={"IN": "float32"},
       outputs={"XOUT": "float32", "AOUT": "float32"})
class FirSeed:
    """Fans each sample into the (x, acc) systolic pair with acc = 0."""

    stream_op = ("fir_seed",)

    @action(name="s", consumes={"IN": 1}, produces={"XOUT": 1, "AOUT": 1})
    def s(st, t):
        v = t["IN"][0]
        return st, {"XOUT": [v], "AOUT": [0.0]}

    def vector_fire(state, ins):
        vals, mask = ins["IN"]
        return state, {"XOUT": (vals, mask), "AOUT": (torch.zeros_like(vals), mask)}


@actor(inputs={"XIN": "float32", "AIN": "float32"},
       outputs={"XOUT": "float32", "AOUT": "float32"})
class Mac:
    """One tap: forward x, accumulate acc + c*x."""

    def __init__(self, c: float):
        self.c = c
        self.stream_op = ("mac", c)

    @action(name="m", consumes={"XIN": 1, "AIN": 1},
            produces={"XOUT": 1, "AOUT": 1})
    def m(self, st, t):
        x = t["XIN"][0]
        a = t["AIN"][0]
        return st, {"XOUT": [x], "AOUT": [a + self.c * x]}

    def vector_fire(self, state, ins):
        xv, xm = ins["XIN"]
        av, am = ins["AIN"]
        return state, {"XOUT": (xv, xm), "AOUT": (av + self.c * xv, am)}


def fir(taps: int = 32, n: int = 4096) -> Tuple[Network, List]:
    net = network(f"FIR{taps}")
    src = _lcg_source(net, n)
    seed = net.add(FirSeed, "seed")
    src.OUT >> seed.IN
    rng = np.random.default_rng(0)
    coeffs = rng.normal(size=(taps,)) / taps
    prev = seed
    for i in range(taps):
        mac = net.add(Mac(float(coeffs[i])), f"mac{i}")
        prev.XOUT >> mac.XIN
        prev.AOUT >> mac.AIN
        prev = mac
    got: List = []
    snk = net.sink("sink", collect=got)
    xsink = net.sink("xsink")  # swallow the x-forward tail
    prev.AOUT >> snk.IN
    prev.XOUT >> xsink.IN
    return net, got


# ---------------------------------------------------------------------------
# Bitonic8 — 8-lane Batcher sorting network of compare-exchange actors
# ---------------------------------------------------------------------------


@actor(inputs={"IN": "float32"},
       outputs={f"O{i}": "float32" for i in range(8)},
       device_ok=False, host_only_reason="rate conversion at ingest")
class Deal:
    """8 sequential tokens -> one on each lane."""

    @action(name="d", consumes={"IN": 8},
            produces={f"O{i}": 1 for i in range(8)})
    def d(st, t):
        vals = t["IN"]
        return st, {f"O{i}": [vals[i]] for i in range(8)}


@actor(inputs={"IN0": "float32", "IN1": "float32"},
       outputs={"OUT0": "float32", "OUT1": "float32"})
class CompareExchange:
    def __init__(self, ascending: bool = True):
        self.ascending = ascending
        self.stream_op = ("cmpx", ascending)

    @action(name="ce", consumes={"IN0": 1, "IN1": 1},
            produces={"OUT0": 1, "OUT1": 1})
    def ce(self, st, t):
        a, b = t["IN0"][0], t["IN1"][0]
        lo, hi = (min(a, b), max(a, b))
        if not self.ascending:
            lo, hi = hi, lo
        return st, {"OUT0": [lo], "OUT1": [hi]}

    def vector_fire(self, state, ins):
        a, am = ins["IN0"]
        b, bm = ins["IN1"]
        lo = torch.minimum(a, b)
        hi = torch.maximum(a, b)
        if not self.ascending:
            lo, hi = hi, lo
        return state, {"OUT0": (lo, am), "OUT1": (hi, bm)}


@actor(inputs={f"I{i}": "float32" for i in range(8)},
       outputs={"OUT": "float32"},
       device_ok=False, host_only_reason="rate conversion at egress")
class Merge:
    """One token per lane -> 8 sequential tokens."""

    @action(name="m", consumes={f"I{i}": 1 for i in range(8)},
            produces={"OUT": 8})
    def m(st, t):
        return st, {"OUT": [t[f"I{i}"][0] for i in range(8)]}


# bitonic network stage structure for 8 lanes (Batcher)
_BITONIC_STAGES = [
    [(0, 1, True), (2, 3, False), (4, 5, True), (6, 7, False)],
    [(0, 2, True), (1, 3, True), (4, 6, False), (5, 7, False)],
    [(0, 1, True), (2, 3, True), (4, 5, False), (6, 7, False)],
    [(0, 4, True), (1, 5, True), (2, 6, True), (3, 7, True)],
    [(0, 2, True), (1, 3, True), (4, 6, True), (5, 7, True)],
    [(0, 1, True), (2, 3, True), (4, 5, True), (6, 7, True)],
]


def bitonic8(n_vectors: int = 512) -> Tuple[Network, List]:
    net = network("Bitonic8")
    src = _lcg_source(net, n_vectors * 8, mod=1000)
    deal = net.add(Deal, "deal")
    src.OUT >> deal.IN

    wires = {i: deal.port(f"O{i}") for i in range(8)}
    k = 0
    for stage in _BITONIC_STAGES:
        for (i, j, asc) in stage:
            ce = net.add(CompareExchange(asc), f"ce{k}")
            k += 1
            wires[i] >> ce.IN0
            wires[j] >> ce.IN1
            wires[i] = ce.OUT0
            wires[j] = ce.OUT1

    merge = net.add(Merge, "merge")
    for i in range(8):
        wires[i] >> merge.port(f"I{i}")
    got: List = []
    snk = net.sink("sink", collect=got)
    merge.OUT >> snk.IN
    return net, got


# ---------------------------------------------------------------------------
# IDCT8 — scale -> idct (8-token SDF matmul actor) -> clip
# ---------------------------------------------------------------------------


def _idct_basis() -> np.ndarray:
    basis = np.zeros((8, 8), np.float32)
    for kk in range(8):
        for nn in range(8):
            c = math.sqrt(0.5) if kk == 0 else 1.0
            basis[kk, nn] = c * math.cos(math.pi * (nn + 0.5) * kk / 8.0) / 2.0
    return basis


_IDCT_BASIS = _idct_basis()


@actor(inputs={"IN": "float32"}, outputs={"OUT": "float32"})
class Idct:
    """8-point IDCT: one SDF firing transforms a block of 8 tokens."""

    stream_op = ("matmul8", _IDCT_BASIS)

    @action(name="t", consumes={"IN": 8}, produces={"OUT": 8})
    def t(st, t):
        x = np.asarray(t["IN"], np.float32)
        y = x @ _IDCT_BASIS
        return st, {"OUT": [float(v) for v in y]}

    def vector_fire(state, ins):
        vals, mask = ins["IN"]
        return state, {"OUT": (matmul8(vals, _IDCT_BASIS), mask)}


def _descale_vf(state, ins):
    vals, mask = ins["IN"]
    return state, {"OUT": ((vals - 128.0) / 8.0, mask)}


def _clip_vf(state, ins):
    vals, mask = ins["IN"]
    return state, {"OUT": (torch.clamp(vals, -256.0, 255.0), mask)}


def idct8(n_blocks: int = 512) -> Tuple[Network, List]:
    net = network("IDCT8")
    src = _lcg_source(net, n_blocks * 8, mod=256)
    descale = net.map("descale", lambda st, v: (st, (v - 128.0) / 8.0),
                      vector_fire=_descale_vf,
                      stream_op=("affine", -128.0, 0.125, 0.0))
    idct = net.add(Idct, "idct")
    clip = net.map("clip", lambda st, v: (st, max(-256.0, min(255.0, v))),
                   vector_fire=_clip_vf,
                   stream_op=("clip", -256.0, 255.0))
    got: List = []
    snk = net.sink("sink", collect=got)
    src >> descale >> idct >> clip >> snk
    return net, got


# ---------------------------------------------------------------------------
# ZigZag — JPEG zigzag descan: 64-token SDF reorder (paper: RVC-CAL JPEG)
# ---------------------------------------------------------------------------


def _zigzag_order() -> np.ndarray:
    """Raster index of each position in JPEG zigzag scan order (8x8)."""
    order = sorted(
        ((r, c) for r in range(8) for c in range(8)),
        key=lambda rc: (
            rc[0] + rc[1],
            # even anti-diagonals run bottom-left -> top-right (ascending
            # column), odd ones top-right -> bottom-left (ascending row)
            rc[0] if (rc[0] + rc[1]) % 2 else rc[1],
        ),
    )
    return np.asarray([r * 8 + c for r, c in order], np.int32)


_ZIGZAG = _zigzag_order()
# inverse permutation: output position j takes input token _ZIGZAG_INV[j]
_ZIGZAG_INV = np.argsort(_ZIGZAG).astype(np.int32)


@actor(inputs={"IN": "float32"}, outputs={"OUT": "float32"})
class ZigZagScan:
    """De-zigzag: one SDF firing reorders a 64-token scan block to raster."""

    stream_op = ("perm", _ZIGZAG_INV)

    @action(name="z", consumes={"IN": 64}, produces={"OUT": 64})
    def z(st, t):
        vals = t["IN"]
        return st, {"OUT": [vals[int(i)] for i in _ZIGZAG_INV]}

    def vector_fire(state, ins):
        vals, mask = ins["IN"]
        idx = device_const(_ZIGZAG_INV.astype(np.int64), vals.device)
        y = vals.reshape(-1, 64)[:, idx].reshape(-1)
        return state, {"OUT": (y, mask)}


def zigzag(n_blocks: int = 512) -> Tuple[Network, List]:
    net = network("ZigZag")
    src = _lcg_source(net, n_blocks * 64, mod=256)
    zz = net.add(ZigZagScan, "zigzag")
    clip = net.map("clip", lambda st, v: (st, max(-256.0, min(255.0, v))),
                   vector_fire=_clip_vf,
                   stream_op=("clip", -256.0, 255.0))
    got: List = []
    snk = net.sink("sink", collect=got)
    src >> zz >> clip >> snk
    return net, got


# ---------------------------------------------------------------------------
# Seed-API shims + registries
# ---------------------------------------------------------------------------


def make_topfilter(n: int = 4096, param: float = 50.0) -> Tuple[ActorGraph, List]:
    net, got = topfilter(n, param)
    return net.graph(), got


def make_fir(taps: int = 32, n: int = 4096) -> Tuple[ActorGraph, List]:
    net, got = fir(taps, n)
    return net.graph(), got


def make_bitonic8(n_vectors: int = 512) -> Tuple[ActorGraph, List]:
    net, got = bitonic8(n_vectors)
    return net.graph(), got


def make_idct8(n_blocks: int = 512) -> Tuple[ActorGraph, List]:
    net, got = idct8(n_blocks)
    return net.graph(), got


def make_zigzag(n_blocks: int = 512) -> Tuple[ActorGraph, List]:
    net, got = zigzag(n_blocks)
    return net.graph(), got


# DSL builders: name -> callable returning (Network, outputs)
NETWORKS = {
    "TopFilter": topfilter,
    "FIR32": fir,
    "Bitonic8": bitonic8,
    "IDCT8": idct8,
    "ZigZag": zigzag,
}

# Seed-compatible: name -> callable returning (ActorGraph, outputs)
BENCHMARKS = {
    "TopFilter": make_topfilter,
    "FIR32": make_fir,
    "Bitonic8": make_bitonic8,
    "IDCT8": make_idct8,
    "ZigZag": make_zigzag,
}
