"""Multi-threaded software runtime (paper §III-C).

Both runtimes consume *lowered IR* (``repro_torch.ir.IRModule``): regions say which
thread owns which actor, channels carry their resolved FIFO depths, and the
device partition (if any) is already legalized and fused.  Raw
``ActorGraph`` + mapping is still accepted — it is lowered on the spot
through the same pass pipeline, so there is exactly one road from authored
graphs to executable runtimes.

Each thread owns a *partition* of actor instances and runs the three-step loop:

  Pre-fire  — snapshot the published counters of every FIFO endpoint it owns,
  Fire      — invoke each actor machine round-robin (up to an exec threshold),
  Post-fire — publish its local counters; decide iterate / sleep / terminate.

Termination is the paper's quiescence rule: all threads asleep and a full round in
which no thread produced or consumed a token.  Threads sleep on a condition
variable and are woken when another thread publishes production.

Profiling (§III-E): per-actor firing counts and wall time (perf_counter_ns — the
rdtscp analogue), plus per-channel token totals; these feed the MILP partitioner.

Port of ``repro/runtime/scheduler.py``: the host runtime is unchanged, and
``HeteroRuntime`` builds the port's device programs and PLink lanes on the
``device`` it is given (default ``cuda:0``).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.actor_machine import ActorMachine, BasicController, PortEnv
from repro_torch.core.xcf import make_xcf
from repro_torch.ir.ir import IRModule
from repro_torch.observability.recorder import current as _trace_current
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime.fifo import ReaderEndpoint, RingFifo, WriterEndpoint

DEFAULT_DEPTH = 4096

# Sentinel accel id that matches no partition: a plain actor->thread mapping
# lowered through make_xcf must produce sw regions only.
_NO_HW = "__no_hw__"


class AdaptiveBackoff:
    """Exponential wait ramp for async-completion polling.

    The device step completes without any host-side notification (PLink
    polls a CUDA event rather than block on it), so waiters must poll —
    but a fixed poll period either burns a core (too short) or adds latency
    to every launch (too long), and a server keeps runtimes alive
    *indefinitely*.  This ramp spins a few times (a step that is nearly done
    costs nothing extra), then sleeps exponentially longer up to ``cap``;
    any observed progress ``reset()``s it.  Threaded waiters pass
    ``next_timeout()`` to a condition-variable wait instead of sleeping, so
    a publish from another thread still wakes them immediately.
    """

    def __init__(
        self, first: float = 20e-6, cap: float = 2e-3, spins: int = 2
    ):
        self.first = first
        self.cap = cap
        self.spins = spins
        self._n = 0

    def reset(self) -> None:
        self._n = 0

    def next_timeout(self) -> float:
        """The wait budget for the next poll (0.0 while still spinning)."""
        n = self._n
        self._n += 1
        if n < self.spins:
            return 0.0
        return min(self.first * (2.0 ** (n - self.spins)), self.cap)

    def pause(self) -> None:
        """Sleep for the next budget (single-threaded waiters)."""
        t = self.next_timeout()
        if t > 0.0:
            time.sleep(t)


@dataclass
class ActorProfile:
    fires: int = 0
    invocations: int = 0
    time_ns: int = 0
    tests: int = 0

    @property
    def ns_per_fire(self) -> float:
        return self.time_ns / max(self.fires, 1)


class ThreadPartition:
    def __init__(self, name: str, runtime: "HostRuntime"):
        self.name = name
        self.rt = runtime
        self.instances: List = []  # ActorMachine | BasicController
        self.reader_fifos: List[RingFifo] = []
        self.writer_fifos: List[RingFifo] = []
        self.rounds = 0

    def pre_fire(self) -> None:
        for f in self.reader_fifos:
            f.snapshot_reader()
        for f in self.writer_fifos:
            f.snapshot_writer()

    def fire(self) -> int:
        execs = 0
        rec = self.rt.recorder
        for inst in self.instances:
            # chaos site: scheduler-run actor faults (serve-mode pokes the
            # per-session variant ``actor:<name>@s<sid>`` instead)
            chaos_mod.poke(f"actor:{inst.actor.name}@{self.name}")
            t0 = time.perf_counter_ns()
            e = inst.invoke(self.rt.max_execs_per_invoke)
            dt = time.perf_counter_ns() - t0
            prof = self.rt.profiles[inst.actor.name]
            prof.fires += e
            prof.invocations += 1
            prof.time_ns += dt
            prof.tests = inst.stats.tests
            execs += e
            # streamtrace: one span per productive invoke, on this thread's
            # track.  PLink records its own phase spans (trace_self) — an
            # extra whole-invoke span would double-paint its lane.
            if rec is not None and e and not getattr(inst, "trace_self", False):
                rec.complete(
                    f"thread:{self.name}",
                    getattr(inst, "telemetry_key", inst.actor.name),
                    "actor",
                    t0,
                    dt,
                    {"fires": e},
                )
        return execs

    def post_fire(self) -> None:
        for f in self.writer_fifos:
            f.publish_writer()
        for f in self.reader_fifos:
            f.publish_reader()
        self.rounds += 1

    def run_round(self) -> int:
        self.pre_fire()
        e = self.fire()
        self.post_fire()
        return e

    def has_pending_async(self) -> bool:
        """True if any instance (e.g. a PLink) has an async step in flight
        whose retirement may still move tokens."""
        return any(getattr(inst, "pending", False) for inst in self.instances)


def _lower_host(graph, mapping, default_depth: int) -> IRModule:
    from repro_torch.ir.passes import lower

    mapping = mapping or {a: "t0" for a in graph.actors}
    return lower(
        graph,
        make_xcf(graph.name, mapping, accel=_NO_HW),
        default_depth=default_depth,
        fuse=False,
    )


class HostRuntime:
    """Builds FIFOs + actor machines from a lowered module (or a graph + an
    actor→thread mapping, lowered on the spot)."""

    def __init__(
        self,
        src,  # IRModule | ActorGraph
        mapping: Optional[Dict[str, str]] = None,  # actor -> partition name
        *,
        controller: str = "am",  # "am" | "basic"
        default_depth: int = DEFAULT_DEPTH,
        max_execs_per_invoke: int = 10_000,
        pin_threads: bool = False,
    ):
        if isinstance(src, IRModule):
            if mapping is not None:
                raise ValueError(
                    "HostRuntime(module): the lowered module already fixes "
                    "the placement; pass a graph to use mapping="
                )
            module = src
        else:
            module = _lower_host(src, mapping, default_depth)
        self.module = module
        self.graph = module.source
        self.max_execs_per_invoke = max_execs_per_invoke
        self.controller_kind = controller
        self.pin_threads = pin_threads
        # streamtrace: capture the process-current recorder once — the hot
        # fire loop then pays a plain attribute read + None check when
        # tracing is off
        self.recorder = _trace_current()
        mapping = module.assignment()
        self.mapping = dict(mapping)

        self.partitions: Dict[str, ThreadPartition] = {}
        for a, part in mapping.items():
            self.partitions.setdefault(part, ThreadPartition(part, self))

        # FIFOs: deferred protocol only when the endpoints are on different threads
        self.fifos: Dict[str, RingFifo] = {}
        readers: Dict[str, Dict[str, ReaderEndpoint]] = {a: {} for a in module.actors}
        writers: Dict[str, Dict[str, WriterEndpoint]] = {a: {} for a in module.actors}
        for ch in module.channels:
            cross = mapping[ch.src] != mapping[ch.dst]
            f = RingFifo(
                ch.resolved_depth or default_depth, name=str(ch), deferred=cross
            )
            self.fifos[str(ch)] = f
            writers[ch.src][ch.src_port] = WriterEndpoint(f)
            readers[ch.dst][ch.dst_port] = ReaderEndpoint(f)
            self.partitions[mapping[ch.src]].writer_fifos.append(f)
            self.partitions[mapping[ch.dst]].reader_fifos.append(f)

        self.profiles: Dict[str, ActorProfile] = {}
        self.instances: Dict[str, object] = {}
        for name, ir_actor in module.actors.items():
            env = PortEnv(readers[name], writers[name])
            inst = (
                ActorMachine(ir_actor.impl, env)
                if controller == "am"
                else BasicController(ir_actor.impl, env)
            )
            self.instances[name] = inst
            self.partitions[mapping[name]].instances.append(inst)
            self.profiles[name] = ActorProfile()
        self.host_fused = self._attach_host_fused(module, readers, writers)

        # quiescence machinery
        self._cv = threading.Condition()
        self._progress = 0  # total execs, all threads
        self._terminate = False

    def _attach_host_fused(self, module, readers, writers):
        """Replace each fused host group's member machines with one
        ``HostFusedRegion`` block executor on the owning thread (see
        ``repro_torch.runtime.host_fused``; groups come from the
        ``fuse-sdf-host-regions`` pass)."""
        if not module.meta.get("host_fused"):
            return {}
        from repro_torch.runtime.host_fused import attach_host_fused

        fifo_of = {
            ch.key: self.fifos[str(ch)]
            for ch in module.channels
            if str(ch) in self.fifos
        }
        regions = attach_host_fused(
            module, self.instances, readers, writers, fifo_of
        )
        for gid, region in regions.items():
            drop = {id(m) for m in region.machines.values()}
            part = self.partitions[self.mapping[region.spec.members[0]]]
            replaced = []
            inserted = False
            for inst in part.instances:
                if id(inst) in drop:
                    if not inserted:  # region takes the first member's slot
                        replaced.append(region)
                        inserted = True
                    continue
                replaced.append(inst)
            if not inserted:
                replaced.append(region)
            part.instances = replaced
            self.profiles[gid] = ActorProfile()
        return regions

    # ------------------------------------------------------------------ single --
    def run_single(
        self,
        max_rounds: int = 1_000_000,
        max_seconds: Optional[float] = None,
        on_deadline: str = "raise",
    ) -> int:
        """Deterministic single-threaded execution (ignores the thread mapping).

        ``max_seconds`` bounds wall-clock time and ``max_rounds`` the round
        count.  A run that ends by budget instead of quiescence raises
        ``StallError`` with a stall report (which actors are blocked on
        which FIFOs, with fill levels) — silently-partial output hides
        hangs.  Callers that *want* the partial result (profilers sampling a
        never-quiescent server pipeline) pass ``on_deadline="return"``.
        """
        from repro_torch.runtime.stall import StallError, stall_report

        assert on_deadline in ("raise", "return"), on_deadline
        deadline = (
            None if max_seconds is None
            else time.perf_counter() + max_seconds
        )
        parts = list(self.partitions.values())
        backoff = AdaptiveBackoff()
        total = 0
        quiesced = False
        expired = ""
        t_run = time.perf_counter_ns()
        for _ in range(max_rounds):
            execs = sum(p.run_round() for p in parts)
            total += execs
            if execs == 0:
                pending = any(p.has_pending_async() for p in parts)
                moved = any(f.unpublished for f in self.fifos.values())
                if not moved and not pending:
                    quiesced = True
                    break
                if pending:  # let the in-flight device step complete
                    backoff.pause()
            else:
                backoff.reset()
            if deadline is not None and time.perf_counter() >= deadline:
                expired = f"max_seconds={max_seconds} expired"
                break
        else:
            expired = f"max_rounds={max_rounds} exhausted without quiescence"
        self._trace_run_end(t_run, quiesced)
        if not quiesced and on_deadline == "raise":
            raise StallError(
                f"{self.module.name}: run_single ended by budget "
                f"({expired}) with the network not quiescent",
                stall_report(self),
            )
        return total

    # ------------------------------------------------------------------ threads --
    def _safe_round(self, part: ThreadPartition) -> Optional[int]:
        """Run one round; on error record it, trigger termination, return None."""
        try:
            return part.run_round()
        except BaseException as e:  # noqa: BLE001 — surface to run_threads
            with self._cv:
                self._thread_error = e
                self._terminate = True
                self._cv.notify_all()
            return None

    def _thread_main(self, part: ThreadPartition, core: Optional[int]) -> None:
        if core is not None and hasattr(os, "sched_setaffinity"):
            try:
                os.sched_setaffinity(0, {core})
            except OSError:
                pass
        backoff = AdaptiveBackoff()
        while True:
            with self._cv:
                if self._terminate:
                    return
            execs = self._safe_round(part)
            if execs is None:
                return
            if execs:
                backoff.reset()
                with self._cv:
                    self._progress += execs
                    self._cv.notify_all()
                continue
            # Quiescence (Dijkstra-style): stamp this thread quiet at the current
            # progress count.  Terminate only when every thread has completed a
            # no-progress round at the *same* progress count — any token movement
            # bumps progress and invalidates all stamps.
            #
            # The stamp must come from a round whose pre-fire FIFO snapshot
            # happened *after* the progress count was read: a publish by another
            # thread can land between this thread's snapshot and its stamp, and
            # stamping the post-publish count against a pre-publish snapshot
            # terminates the network with tokens still in flight.  So capture
            # the count first, run a verification round, and stamp only if the
            # count is unchanged.
            with self._cv:
                if self._terminate:
                    return
                if part.has_pending_async():
                    # An async device step is still in flight: its retirement
                    # will produce/consume tokens, so this thread is not
                    # quiet.  Wait on the condition variable (any publish
                    # wakes us) with an adaptive timeout — a long-lived
                    # hetero runtime must not busy-burn a core polling the
                    # device, and a short fixed timeout is exactly that.
                    self._cv.wait(timeout=max(backoff.next_timeout(), 1e-4))
                    continue
                p0 = self._progress
            execs = self._safe_round(part)
            if execs is None:
                return
            if execs:
                with self._cv:
                    self._progress += execs
                    self._cv.notify_all()
                continue
            with self._cv:
                if self._terminate:
                    return
                if self._progress != p0 or part.has_pending_async():
                    continue  # something moved (or launched) — not quiet
                self._quiet[part.name] = p0
                if all(q == p0 for q in self._quiet.values()):
                    self._terminate = True
                    self._cv.notify_all()
                    return
                self._cv.wait(timeout=0.005)

    def run_threads(
        self,
        n_cores: Optional[int] = None,
        max_seconds: Optional[float] = None,
        on_deadline: str = "raise",
    ) -> float:
        """Run until quiescent; returns wall-clock seconds.

        ``max_seconds`` arms a watchdog: if the network has not quiesced by
        the deadline, every thread is terminated and (under the default
        ``on_deadline="raise"``) a ``StallError`` carrying the stall report
        is raised — a hung placement becomes an actionable diagnosis
        instead of a forever-blocked join.
        """
        from repro_torch.runtime.stall import StallError, stall_report

        assert on_deadline in ("raise", "return"), on_deadline
        self._quiet = {name: -1 for name in self.partitions}
        self._terminate = False
        self._thread_error = None
        self._stalled = False
        avail = list(range(os.cpu_count() or 1))
        threads = []
        t0 = time.perf_counter()
        t_run = time.perf_counter_ns()
        for i, part in enumerate(self.partitions.values()):
            core = avail[i % len(avail)] if self.pin_threads else None
            th = threading.Thread(
                target=self._thread_main, args=(part, core), daemon=True
            )
            threads.append(th)
            th.start()
        if max_seconds is not None:
            def _watchdog() -> None:
                with self._cv:
                    done = self._cv.wait_for(
                        lambda: self._terminate, timeout=max_seconds
                    )
                    if not done:
                        self._stalled = True
                        self._terminate = True
                        self._cv.notify_all()

            wd = threading.Thread(target=_watchdog, daemon=True)
            wd.start()
        for th in threads:
            th.join()
        self._trace_run_end(t_run, not self._stalled)
        if self._thread_error is not None:
            raise self._thread_error
        if self._stalled and on_deadline == "raise":
            raise StallError(
                f"{self.module.name}: run_threads hit max_seconds="
                f"{max_seconds} without quiescence",
                stall_report(self),
            )
        return time.perf_counter() - t0

    def run(self, threaded: Optional[bool] = None) -> float:
        t0 = time.perf_counter()
        threaded = len(self.partitions) > 1 if threaded is None else threaded
        if threaded:
            return self.run_threads()
        self.run_single()
        return time.perf_counter() - t0

    # -------------------------------------------------------------------- stats --
    def channel_tokens(self) -> Dict[str, int]:
        return {k: f.total_written for k, f in self.fifos.items()}

    def total_fires(self) -> int:
        return sum(p.fires for p in self.profiles.values())

    # -------------------------------------------------------------- streamtrace --
    def _trace_run_end(self, t0_ns: int, quiesced: bool) -> None:
        """Close the whole-run span on the ``runtime`` track."""
        if self.recorder is None:
            return
        self.recorder.complete(
            "runtime",
            f"run:{self.module.name}",
            "run",
            t0_ns,
            time.perf_counter_ns() - t0_ns,
            {"quiesced": quiesced, "threads": len(self.partitions)},
        )

    def record_channel_totals(self) -> None:
        """Emit one ``channel`` counter event per live FIFO with the total
        tokens it moved, keyed by the *authored* channel endpoints — what
        ``profile_from_trace`` ingests (the same authored-key convention
        the serving engine's telemetry uses)."""
        if self.recorder is None:
            return
        from repro_torch.observability.trace_profile import authored_channel_key

        for ch in self.module.channels:
            f = self.fifos.get(str(ch))
            if f is None or not f.total_written:
                continue
            src, sp, dst, dp = authored_channel_key(self.module, ch.key)
            self.recorder.counter(
                "channels",
                f"{src}.{sp}->{dst}.{dp}",
                f.total_written,
                cat="channel",
                args={
                    "src": src, "src_port": sp, "dst": dst, "dst_port": dp,
                },
            )


def runtime_from_xcf(graph, xcf, *, fuse: bool = True, **kw):
    """Build the right runtime (host-only or heterogeneous) from an XCF
    configuration — the paper's flow: partitioning is a config artifact.

    Legalization validates every partition up front: an XCF partition whose
    ``code_generator`` this toolchain does not recognize raises a
    ``GraphError`` naming the partition and the known generator set (it used
    to fall through as an unscheduled pseudo-thread).

    Legacy entry point; ``repro_torch.compile(graph, xcf)`` is the supported
    surface (it additionally caches the compiled device partitions across
    runs).
    """
    from repro_torch.ir.passes import lower

    module = lower(
        graph,
        xcf,
        default_depth=kw.get("default_depth", DEFAULT_DEPTH),
        block=kw.get("block", 1024),
        fuse=fuse,
    )
    if module.hw_regions():
        return HeteroRuntime(module, **kw)
    return HostRuntime(module, **kw)


class HeteroRuntime(HostRuntime):
    """Host threads + N compiled device partitions, each bridged by its own
    PLink lane (paper Fig. 6: input/output stages + PLink + dynamic region,
    generalized to a *set* of dynamic regions).

    Every hw region of the module is compiled into its own
    DeviceProgram (SDF sub-regions arrive already fused, per partition, by
    the pipeline).  Channels crossing a host/device boundary become host
    FIFOs read/written by that partition's PLink; channels between two
    *different* device partitions become staged ``ArrayFifo`` lanes — the
    producing PLink queues retired numpy blocks that the consuming PLink
    stages directly, with no per-token Python boxing in between.

    Every PLink gets its own dedicated scheduler thread by default — single
    partition included — so the boundary work (staging ring packing, masked
    retirement) overlaps the host actors' token processing instead of
    serializing behind them on one thread.  Pass ``plink_thread`` to pin
    all lanes onto a named (possibly shared) thread instead — e.g. the
    first host thread, the paper's p1 placement.
    """

    def __init__(
        self,
        src,  # IRModule | ActorGraph
        mapping: Optional[Dict[str, str]] = None,  # host -> thread; device -> accel
        *,
        accel: str = "accel",
        plink_thread: Optional[str] = None,
        block: int = 1024,
        controller: str = "am",
        default_depth: int = DEFAULT_DEPTH,
        max_execs_per_invoke: int = 10_000,
        program=None,  # prebuilt DeviceProgram (single-partition modules)
        programs: Optional[Dict[str, object]] = None,  # pid -> DeviceProgram
        fuse: bool = True,
        megastep: object = "auto",
        device=None,  # the caller's torch device (default cuda:0)
    ):
        from repro_torch.ir.passes import lower
        from repro_torch.runtime.device_runtime import compile_partition
        from repro_torch.runtime.fifo import ArrayFifo
        from repro_torch.runtime.plink import PLink

        if isinstance(src, IRModule):
            if mapping is not None:
                raise ValueError(
                    "HeteroRuntime(module): the lowered module already fixes "
                    "the placement (and its hw region ids override accel=); "
                    "pass a graph to use mapping="
                )
            module = src
        else:
            assert mapping, "HeteroRuntime needs an actor -> partition mapping"
            module = lower(
                src,
                make_xcf(src.name, mapping, accel=accel),
                default_depth=default_depth,
                block=block,
                fuse=fuse,
                megastep=megastep,
            )
        hw_regions = [r for r in module.hw_regions() if r.actors]
        assert hw_regions, "HeteroRuntime needs at least one device actor"
        hw_of = {a: r.id for r in hw_regions for a in r.actors}
        devset = set(hw_of)
        host_map = {
            a: r for a, r in module.assignment().items() if a not in devset
        }
        threads = sorted(set(host_map.values()))
        single = len(hw_regions) == 1
        if plink_thread is not None:
            plink_threads = {r.id: plink_thread for r in hw_regions}
        else:  # one dedicated lane thread per device partition
            plink_threads = {r.id: f"plink:{r.id}" for r in hw_regions}

        self.module = module
        self.graph = module.source
        self.max_execs_per_invoke = max_execs_per_invoke
        self.controller_kind = controller
        self.pin_threads = False
        self.recorder = _trace_current()
        self.mapping = dict(host_map)
        self.partitions = {}
        for part in host_map.values():
            self.partitions.setdefault(part, ThreadPartition(part, self))
        for part in plink_threads.values():
            self.partitions.setdefault(part, ThreadPartition(part, self))

        self.fifos = {}
        readers = {a: {} for a in module.actors if a not in devset}
        writers = {a: {} for a in module.actors if a not in devset}
        plink_in = {r.id: {} for r in hw_regions}
        plink_out = {r.id: {} for r in hw_regions}
        for ch in module.channels:
            s_pid, d_pid = hw_of.get(ch.src), hw_of.get(ch.dst)
            if s_pid is not None and s_pid == d_pid:
                continue  # internal to one device program
            depth = ch.resolved_depth or default_depth
            if s_pid is None and d_pid is None:  # host <-> host
                cross = host_map[ch.src] != host_map[ch.dst]
                f = RingFifo(depth, name=str(ch), deferred=cross)
                self.fifos[str(ch)] = f
                writers[ch.src][ch.src_port] = WriterEndpoint(f)
                readers[ch.dst][ch.dst_port] = ReaderEndpoint(f)
                self.partitions[host_map[ch.src]].writer_fifos.append(f)
                self.partitions[host_map[ch.dst]].reader_fifos.append(f)
            elif s_pid is not None and d_pid is not None:
                # device -> device across partitions: a staged lane pair.
                # ArrayFifo is self-publishing, so neither lane thread needs
                # it in its snapshot/publish lists.
                f = ArrayFifo(depth, name=str(ch))
                self.fifos[str(ch)] = f
                plink_out[s_pid][f"{ch.src}.{ch.src_port}"] = WriterEndpoint(f)
                plink_in[d_pid][f"{ch.dst}.{ch.dst_port}"] = ReaderEndpoint(f)
            elif d_pid is not None:  # host writer -> plink reader
                cross = host_map[ch.src] != plink_threads[d_pid]
                f = RingFifo(depth, name=str(ch), deferred=cross)
                self.fifos[str(ch)] = f
                writers[ch.src][ch.src_port] = WriterEndpoint(f)
                plink_in[d_pid][f"{ch.dst}.{ch.dst_port}"] = ReaderEndpoint(f)
                self.partitions[host_map[ch.src]].writer_fifos.append(f)
                self.partitions[plink_threads[d_pid]].reader_fifos.append(f)
            else:  # plink writer -> host reader
                cross = host_map[ch.dst] != plink_threads[s_pid]
                f = RingFifo(depth, name=str(ch), deferred=cross)
                self.fifos[str(ch)] = f
                plink_out[s_pid][f"{ch.src}.{ch.src_port}"] = WriterEndpoint(f)
                readers[ch.dst][ch.dst_port] = ReaderEndpoint(f)
                self.partitions[plink_threads[s_pid]].writer_fifos.append(f)
                self.partitions[host_map[ch.dst]].reader_fifos.append(f)

        self.profiles = {}
        self.instances = {}
        for name, ir_actor in module.actors.items():
            if name in devset:
                continue
            env = PortEnv(readers[name], writers[name])
            inst = (
                ActorMachine(ir_actor.impl, env)
                if controller == "am"
                else BasicController(ir_actor.impl, env)
            )
            self.instances[name] = inst
            self.partitions[host_map[name]].instances.append(inst)
            self.profiles[name] = ActorProfile()
        self.host_fused = self._attach_host_fused(module, readers, writers)

        if programs is not None and program is not None:
            raise ValueError("pass program= or programs=, not both")
        if program is not None:
            if not single:
                raise ValueError(
                    f"program= carries one device partition but the module "
                    f"has {len(hw_regions)}; pass programs= keyed by "
                    f"partition id"
                )
            programs = {hw_regions[0].id: program}
        self.programs = {}
        self.plinks = {}
        for r in hw_regions:
            device_actors = sorted(r.actors)
            prog = (programs or {}).get(r.id)
            if prog is not None and (
                prog.actors != device_actors or prog.block != block
            ):
                raise ValueError(
                    f"prebuilt device program for {r.id!r} covers "
                    f"{prog.actors} @block={prog.block}, mapping needs "
                    f"{device_actors} @block={block}"
                )
            if prog is None:
                prog = compile_partition(
                    module, block=block, partition=r.id, device=device
                )
            self.programs[r.id] = prog
            lane = "plink" if single else f"plink:{r.id}"
            pl = PLink(
                prog, PortEnv(plink_in[r.id], plink_out[r.id]), name=lane
            )
            self.plinks[r.id] = pl
            self.instances[lane] = pl
            self.partitions[plink_threads[r.id]].instances.append(pl)
            self.profiles[lane] = ActorProfile()

        self._cv = threading.Condition()
        self._progress = 0
        self._terminate = False

    # -- single-partition compatibility surface ------------------------------
    @property
    def plink(self):
        """The single PLink (legacy accessor); first lane when several."""
        return next(iter(self.plinks.values()))

    @property
    def program(self):
        """The single DeviceProgram (legacy accessor); first when several."""
        return next(iter(self.programs.values()))
