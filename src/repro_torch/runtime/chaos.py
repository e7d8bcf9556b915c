"""Deterministic seeded fault injection (chaos) for the streaming runtime.

Reliability code is only trustworthy if its failure paths run constantly;
this module makes them runnable *deterministically*.  A ``Chaos``
controller holds a list of :class:`FaultRule` specs and the runtime pokes
it at named **sites**::

    launch:<partition>    DeviceBatcher.launch entry (serve mode)
    plink:<partition>     PLink.invoke, before the device dispatch
    actor:<name>@s<sid>   serve-mode host actor invoke (per session)
    actor:<name>@<part>   scheduler-mode host actor invoke (per thread)
    ckpt:leaf             checkpoint.save, before each leaf write
    ckpt:commit           checkpoint.save, before the atomic rename

Every injection decision is a pure function of ``(seed, site, occurrence
index)`` — *not* of wall clock, thread interleaving, or a shared RNG
stream — so a failing chaos run replays exactly from its seed, and two
sites never perturb each other's schedules.  Rules trigger by explicit
occurrence index (``at=``), persistently from an index on (``after=``, a
dead lane), or probabilistically (``p=``); ``delay_s`` turns a matching
occurrence into an artificial stall instead of an exception.

The controller is process-global and off by default: ``poke()`` is a
single attribute load when no chaos is installed, so production paths pay
nothing.  Activate for a scope with::

    with chaos.activate(chaos.Chaos([chaos.FaultRule("launch:*", at=(1,))])):
        ...

or for the whole process from the environment (``REPRO_CHAOS`` spec,
``CHAOS_SEED`` seed)::

    REPRO_CHAOS='launch:*|p=0.02;actor:filt@s0|at=3' CHAOS_SEED=7 ...

Faults raise subclasses of :class:`InjectedFault` so handlers (and the
engine's blast-radius policy) can tell injected faults from real bugs
while exercising exactly the same recovery machinery.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple, Union


class InjectedFault(RuntimeError):
    """Base class for every chaos-injected failure."""

    def __init__(self, site: str, occurrence: int, rule: "FaultRule"):
        super().__init__(
            f"injected fault at {site!r} (occurrence {occurrence}, "
            f"rule {rule.spec()!r})"
        )
        self.site = site
        self.occurrence = occurrence
        self.rule = rule


class InjectedLaunchFailure(InjectedFault):
    """A device launch that failed to dispatch (transient or persistent)."""


class InjectedActorFailure(InjectedFault):
    """A host actor raising mid-fire — one session's bug, not the engine's."""


class InjectedLaneDeath(InjectedFault):
    """A PLink lane whose device stopped responding."""


class InjectedCheckpointFailure(InjectedFault):
    """A checkpoint write dying mid-save (torn-write drills)."""


_EXC_BY_PREFIX = {
    "launch": InjectedLaunchFailure,
    "actor": InjectedActorFailure,
    "plink": InjectedLaneDeath,
    "ckpt": InjectedCheckpointFailure,
}


def _exc_for(site: str):
    return _EXC_BY_PREFIX.get(site.split(":", 1)[0], InjectedFault)


@dataclass(frozen=True)
class FaultRule:
    """One injection spec: which sites, and on which occurrences.

    Exactly one trigger should be set; precedence when several are:
    ``at`` > ``after`` > ``p``.  Occurrence indices are 1-based and
    counted **per site string** (not per rule), so two rules matching the
    same site see the same numbering.
    """

    site: str                       # fnmatch pattern over site names
    p: float = 0.0                  # per-occurrence probability
    at: Tuple[int, ...] = ()        # exact occurrence indices (1-based)
    after: Optional[int] = None     # every occurrence >= this index fails
    delay_s: float = 0.0            # stall instead of raising

    def triggers(self, seed: int, site: str, n: int) -> bool:
        if self.at:
            return n in self.at
        if self.after is not None:
            return n >= self.after
        if self.p > 0.0:
            # hash-derived uniform: deterministic per (seed, site, n),
            # independent of call interleaving across sites/threads
            h = hashlib.blake2b(
                f"{seed}:{site}:{n}".encode(), digest_size=8
            ).digest()
            return int.from_bytes(h, "big") / 2.0**64 < self.p
        return False

    def spec(self) -> str:
        parts = [self.site]
        if self.at:
            parts.append("at=" + ",".join(map(str, self.at)))
        if self.after is not None:
            parts.append(f"after={self.after}")
        if self.p:
            parts.append(f"p={self.p}")
        if self.delay_s:
            parts.append(f"delay={self.delay_s}")
        return "|".join(parts)


def default_seed() -> int:
    """The process-wide chaos seed (``CHAOS_SEED`` env, default 0) — CI
    pins it so a failing chaos smoke reproduces locally with one env var."""
    return int(os.environ.get("CHAOS_SEED", "0"))


class Chaos:
    """A deterministic fault-injection schedule over named runtime sites."""

    def __init__(
        self, rules: Iterable[Union[FaultRule, str]], seed: Optional[int] = None
    ):
        self.rules: List[FaultRule] = [
            _parse_rule(r) if isinstance(r, str) else r for r in rules
        ]
        self.seed = default_seed() if seed is None else int(seed)
        self._counts: Dict[str, int] = {}
        self._hits: List[Tuple[str, int, str]] = []  # (site, n, rule spec)
        self._lock = threading.Lock()

    def poke(self, site: str) -> None:
        """Count one occurrence of ``site``; raise or stall when a rule
        matches.  Called from runtime hot paths — cheap when no rule's
        pattern matches the site's prefix family."""
        with self._lock:
            n = self._counts.get(site, 0) + 1
            self._counts[site] = n
            rule = self._match(site, n)
            if rule is not None:
                self._hits.append((site, n, rule.spec()))
        if rule is None:
            return
        if rule.delay_s > 0.0:
            time.sleep(rule.delay_s)
            return
        raise _exc_for(site)(site, n, rule)

    def _match(self, site: str, n: int) -> Optional[FaultRule]:
        for rule in self.rules:
            if fnmatch.fnmatchcase(site, rule.site) and rule.triggers(
                self.seed, site, n
            ):
                return rule
        return None

    @property
    def hits(self) -> List[Tuple[str, int, str]]:
        """Every injected fault so far as ``(site, occurrence, rule)``."""
        with self._lock:
            return list(self._hits)

    def occurrences(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def __repr__(self):
        return (
            f"Chaos(seed={self.seed}, rules="
            f"[{'; '.join(r.spec() for r in self.rules)}], "
            f"hits={len(self._hits)})"
        )


def _parse_rule(text: str) -> FaultRule:
    """Parse one ``site|k=v|...`` rule (the ``REPRO_CHAOS`` entry format)."""
    parts = [p.strip() for p in text.split("|") if p.strip()]
    if not parts:
        raise ValueError(f"empty chaos rule in {text!r}")
    kw: Dict[str, object] = {}
    for p in parts[1:]:
        k, _, v = p.partition("=")
        k = k.strip()
        if k == "at":
            kw["at"] = tuple(int(x) for x in v.split(",") if x)
        elif k == "after":
            kw["after"] = int(v)
        elif k == "p":
            kw["p"] = float(v)
        elif k in ("delay", "delay_s"):
            kw["delay_s"] = float(v)
        else:
            raise ValueError(f"unknown chaos rule field {k!r} in {text!r}")
    return FaultRule(parts[0], **kw)


def parse(spec: str, seed: Optional[int] = None) -> Chaos:
    """Parse a full ``REPRO_CHAOS`` spec: rules separated by ``;``."""
    rules = [_parse_rule(r) for r in spec.split(";") if r.strip()]
    return Chaos(rules, seed=seed)


def coerce(value) -> Optional["Chaos"]:
    """Normalize the ``chaos=`` knob: Chaos | spec string | rule list | None."""
    if value is None or isinstance(value, Chaos):
        return value
    if isinstance(value, str):
        return parse(value)
    return Chaos(value)


# -- process-global controller ----------------------------------------------

_installed: Optional[Chaos] = None


def install(controller: Optional[Chaos]) -> None:
    """Install (or clear, with None) the process-global controller."""
    global _installed
    _installed = controller


def current() -> Optional[Chaos]:
    return _installed


@dataclass
class _Activation:
    controller: Optional[Chaos]
    _prev: Optional[Chaos] = field(default=None, repr=False)

    def __enter__(self) -> Optional[Chaos]:
        global _installed
        self._prev = _installed
        _installed = self.controller
        return self.controller

    def __exit__(self, *exc) -> None:
        global _installed
        _installed = self._prev


def activate(controller: Optional[Chaos]) -> _Activation:
    """Scoped install: ``with chaos.activate(c): ...`` (tests)."""
    return _Activation(controller)


def from_env() -> Optional[Chaos]:
    """Build a controller from ``REPRO_CHAOS`` / ``CHAOS_SEED`` (or None)."""
    spec = os.environ.get("REPRO_CHAOS", "").strip()
    if not spec:
        return None
    return parse(spec)


def poke(site: str) -> None:
    """Poke the process-global controller, if any — the one-attribute-load
    fast path every instrumented runtime site calls."""
    c = _installed
    if c is not None:
        c.poke(site)
