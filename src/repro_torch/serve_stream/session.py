"""Client sessions and their per-session pipelines.

A ``StreamSession`` is one client's private stream through the server's
shared compiled ``Program``: a bounded *admission queue* per ingress port
(backpressure: ``submit`` blocks or raises when the queue is full), a
private ``SessionPipeline`` executing the program's host actors over the
session's tokens, and per-egress result buffers.

The pipeline is the serve-mode reading of the lowered module (Fig. 6):

  * **source actors** (no input ports) are *not* instantiated — in serve
    mode the client IS the source, so each source's output channel becomes
    an ingress FIFO pumped from the session's admission queue;
  * **sink actors** (no output ports) are *not* instantiated — their input
    channels become egress FIFOs drained into ``session.output(port)``;
  * **device actors** are replaced by one ``DeviceStage`` per device
    partition: the PLink lane's stage/retire halves with the launch in the
    middle handed to that partition's shared ``DeviceBatcher``, so B
    sessions' blocks ride one batched dispatch per lane (device→device
    channels between partitions stay numpy blocks in an ``ArrayFifo``);
  * remaining host actors run as ordinary actor machines on the engine
    thread (single-threaded per session, so every FIFO is non-deferred) —
    except fused static-rate regions (``meta["host_fused"]``), whose member
    machines collapse into one block-wise ``HostFusedRegion`` executor per
    session, exactly the one the thread scheduler fires (see
    docs/runtime.md).

Token values take exactly the PLink path (float32 staging, masked write-
back), so a session's outputs are bit-identical to a sequential
``Program.run()`` over the same input stream.

Copy of ``repro/serve_stream/session.py``.  Edits: ``DeviceStage`` stages
numpy buffers in the numpy form of the port's staging dtype
(``runtime/plink.py::_host_dtype``; bfloat16, which numpy lacks, as
float32), and the batcher hands them to the device as torch tensors.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.actor_machine import ActorMachine, BasicController, PortEnv
from repro_torch.ir.ir import IRModule
from repro_torch.observability.trace_profile import authored_channel_key
from repro_torch.runtime.fifo import ReaderEndpoint, RingFifo, WriterEndpoint
from repro_torch.runtime.plink import _host_dtype


def _np_dtype(dt: str) -> np.dtype:
    """The numpy dtype a boundary port stages in on the host."""
    t = _host_dtype(dt)
    if t == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=t).numpy().dtype


class ServeError(RuntimeError):
    """Invalid use of the streaming server."""


class AdmissionFull(ServeError):
    """Non-blocking submit against a full admission queue."""


class StreamSession:
    """One client stream.  ``submit`` / ``close`` are called from the client
    thread; everything else is driven by the engine thread."""

    def __init__(
        self,
        sid: int,
        server,
        ingress: Sequence[str],
        egress: Sequence[str],
        admission_depth: int,
    ):
        self.sid = sid
        self._server = server
        self.ingress = list(ingress)
        self.egress = list(egress)
        # Cross-thread channel: the client thread owns the writer endpoint
        # (submit), the engine thread owns the reader (pump) — so this MUST
        # use the deferred snapshot/publish protocol.  deferred=False's
        # _sync_now republishes *both* counters and is only safe when one
        # thread owns both endpoints.
        self.queues: Dict[str, RingFifo] = {
            name: RingFifo(
                admission_depth, name=f"s{sid}:{name}", deferred=True
            )
            for name in ingress
        }
        self.results: Dict[str, List] = {name: [] for name in egress}
        self.closed = False
        self.finished = threading.Event()
        self.pipeline: Optional[SessionPipeline] = None  # set by the server
        self.submitted_tokens = 0
        self.error: Optional[str] = None  # set by the engine on a dead stream
        # SLO timestamps (perf_counter_ns): TTFO = first delivery − first
        # submit; inter-block latency = gap between consecutive deliveries.
        # Written by the client thread (first_submit) and the engine thread
        # (deliveries) — single writer each, so no lock.
        self.first_submit_ns: Optional[int] = None
        self.first_delivery_ns: Optional[int] = None
        self.last_delivery_ns: Optional[int] = None

    # -- client side ---------------------------------------------------------
    def submit(
        self,
        values: Sequence,
        port: Optional[str] = None,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> None:
        """Enqueue one input submission, with admission backpressure.

        ``port`` may be omitted for single-ingress programs.  A submission
        larger than the admission chunk (``server.admission_chunk``, default
        the queue capacity) is *split at admission*: chunks enter the queue
        one at a time under backpressure, so one huge submission trickles in
        while the engine keeps serving every other stream — it can no
        longer park a whole stream's tokens ahead of everyone else's.

        When the queue lacks space: ``block=True`` waits (engine drains
        it), ``block=False`` raises ``AdmissionFull`` unless the *entire*
        submission fits right now — the client's cue to slow down.
        """
        if self.closed:
            raise ServeError(f"session {self.sid}: submit after close()")
        if port is None:
            if len(self.queues) != 1:
                raise ServeError(
                    f"session {self.sid}: program has ingress ports "
                    f"{sorted(self.queues)}; pass port="
                )
            port = next(iter(self.queues))
        try:
            q = self.queues[port]
        except KeyError:
            raise ServeError(
                f"session {self.sid}: unknown ingress {port!r} "
                f"(have {sorted(self.queues)})"
            ) from None
        values = list(values)
        # TTFO stamps BEFORE any admission wait: the SLO clock starts when
        # the client handed us tokens, so queueing delay under backpressure
        # is part of what the histogram measures, not silently excluded
        if self.first_submit_ns is None:
            self.first_submit_ns = time.perf_counter_ns()
        deadline = None if timeout is None else time.perf_counter() + timeout
        q.snapshot_writer()  # see the engine's latest published reads
        if not block and q.space() < len(values):
            raise AdmissionFull(
                f"session {self.sid}: admission queue {port!r} full "
                f"({q.capacity} tokens)"
            )
        step = min(
            q.capacity,
            getattr(self._server, "admission_chunk", None) or q.capacity,
        )
        for i in range(0, max(len(values), 1), step):
            chunk = values[i:i + step]
            while q.space() < len(chunk):
                if not self._server.wait_for_space(deadline):
                    # the deadline and the engine freeing space can race:
                    # re-check before failing a submit that would now fit
                    q.snapshot_writer()
                    if q.space() >= len(chunk):
                        break
                    raise AdmissionFull(
                        f"session {self.sid}: submit timed out after "
                        f"{timeout}s waiting for admission space on "
                        f"{port!r}"
                    )
                q.snapshot_writer()
            q.write(chunk)
            q.publish_writer()  # make the chunk visible to the engine thread
            self.submitted_tokens += len(chunk)
            split = 1 if len(values) > step and i == 0 else 0
            rec = getattr(self._server, "recorder", None)
            if rec is not None:
                rec.instant(
                    f"session:{self.sid}", "submit", "session",
                    {
                        "chunks": 1, "tokens": len(chunk),
                        "queued": q.count(), "split": split,
                    },
                )
            self._server.notify_work(
                chunks=1, tokens=len(chunk), split=split,
            )

    def close(self) -> None:
        """Mark end-of-stream; the session finishes once fully drained."""
        self.closed = True
        self._server.notify_work()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted token has been processed & delivered."""
        return self.finished.wait(timeout)

    # -- engine side ---------------------------------------------------------
    def queued_tokens(self, port: str) -> int:
        """Fresh reader-side count of one admission queue (engine thread
        only — snapshots the writer's latest publish)."""
        q = self.queues[port]
        q.snapshot_reader()
        return q.count()

    def output(self, port: Optional[str] = None) -> List:
        """Tokens delivered on one egress port (the only one by default)."""
        if self.error is not None:
            raise ServeError(self.error)
        if port is None:
            if len(self.results) != 1:
                # multi-sink programs: prefer the collecting sink if unique
                raise ServeError(
                    f"session {self.sid}: program has egress ports "
                    f"{sorted(self.results)}; pass port="
                )
            port = next(iter(self.results))
        return self.results[port]


# ---------------------------------------------------------------------------
# Device stage — the PLink split open around the shared batcher
# ---------------------------------------------------------------------------


class DeviceStage:
    """Per-session stage/retire halves of one device partition's dispatch.

    Owns the session's state for one device partition and the FIFOs
    crossing that partition's boundary.  ``stage()`` drains boundary FIFOs
    into one ``(block,)`` staged payload — quantized to whole region
    iterations per destination actor (the plan precomputed on the
    ``DeviceProgram``) so a multi-rate op (e.g. the 8-point IDCT) never
    sees a torn block, and lockstep ports of one actor stay lane-aligned;
    the partition's batcher stacks payloads from many sessions into one
    launch and routes each lane's outputs back through ``retire()``.
    """

    def __init__(self, program, module: IRModule):
        self.program = program
        self.partition = getattr(program, "partition", "") or program.name
        self.state = {a: dict(s) for a, s in program.init_state.items()}
        self.in_eps: Dict[str, ReaderEndpoint] = {}
        self.out_eps: Dict[str, WriterEndpoint] = {}
        # boundary ports grouped by destination actor; per-port granule =
        # lcm(port rate, region iteration quantum) — shared with PLink via
        # the program's staging plan
        self.groups: Dict[str, List[str]] = dict(program.in_groups)
        self.quantum: Dict[str, int] = dict(program.in_quanta)
        self.dtypes: Dict[str, object] = {
            f"{a}.{p}": _np_dtype(dt) for (a, p, dt) in program.in_ports
        }
        self.inflight = 0  # rounds this stage is riding right now
        self.tokens_staged = 0
        self.tokens_retired = 0
        # megastep: payloads are (k, block) chunk stacks when the program
        # runs k>1 repetition-vector iterations per launch
        self.k = max(1, getattr(program, "megastep_k", 1))
        shape = (self.k, program.block) if self.k > 1 else (program.block,)
        # preallocated staging buffers, reused across launches — safe
        # because the batcher copies them (``pack_lanes`` stacks them into
        # fresh host tensors for both modes) inside the same ``launch`` call
        # that staged them, before any other stage() can repack
        self._bufs: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
            key: (np.zeros(shape, dt), np.zeros(shape, bool))
            for key, dt in self.dtypes.items()
        }

    @property
    def pending(self) -> bool:
        """Riding at least one in-flight round (legacy name)."""
        return self.inflight > 0

    def _plan(self) -> Dict[str, int]:
        """Tokens stageable per boundary port right now (whole granules,
        lane-aligned across each actor's ports, capped at one block)."""
        block = self.program.block
        plan: Dict[str, int] = {}
        for _actor, keys in self.groups.items():
            g = min(
                min(self.in_eps[k].count(), block) // self.quantum[k]
                for k in keys
            )
            if g > 0:
                for k in keys:
                    plan[k] = g * self.quantum[k]
        return plan

    def ready_tokens(self) -> int:
        """Tokens a ``stage()`` call would drain right now."""
        return sum(self._plan().values())

    def stage(self) -> Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
        """Drain up to ``k`` blocks per port into the reused staging
        buffers; None when nothing to do.  Riding an in-flight round does
        NOT block staging the next one — the continuous batcher chains
        rounds through the device-state future, so a session streams
        back-to-back launches without a drain barrier."""
        plan = self._plan()
        if not plan:
            return None
        total = 0
        for j in range(self.k):
            if j > 0:
                plan = self._plan()
            for key in self.quantum:  # every in-port appears in the payload
                arr, mask = self._bufs[key]
                row_a = arr[j] if self.k > 1 else arr
                row_m = mask[j] if self.k > 1 else mask
                n = plan.get(key, 0)
                if n:
                    ep = self.in_eps[key]
                    view = (
                        ep.peek_view(n)
                        if hasattr(ep, "peek_view") else None
                    )
                    if view is not None:
                        row_a[:n] = np.asarray(view, dtype=arr.dtype)
                        ep.commit(n)
                    else:
                        row_a[:n] = np.asarray(ep.read(n), dtype=arr.dtype)
                # zero the tail: reused buffers must never leak a previous
                # launch's tokens into masked-off padding
                row_a[n:] = 0
                row_m[:n] = True
                row_m[n:] = False
                total += n
            if not plan and j + 1 < self.k:
                for arr, mask in self._bufs.values():
                    arr[j + 1:] = 0
                    mask[j + 1:] = False
                break
        staged = {key: self._bufs[key] for key in self.quantum}
        self.tokens_staged += total
        return staged

    def retire(self, outs) -> int:
        """Write one lane's outputs back to the host FIFOs (PLink §III-D).

        State is NOT written back here: the batcher rebinds ``self.state``
        to the launch's output-state future at dispatch time, which is what
        lets the next round launch before this one retires."""
        moved = 0
        for key, (vals, mask) in outs.items():
            vals = np.asarray(vals)
            keep = vals[np.asarray(mask)]
            if keep.size:
                # a RingFifo boxes host tokens; a device->device ArrayFifo
                # queues the array itself
                self.out_eps[key].write(keep)
                moved += int(keep.size)
        self.inflight -= 1
        self.tokens_retired += moved
        return moved

    def idle(self) -> bool:
        return not self.inflight and not self._plan()


# ---------------------------------------------------------------------------
# Session pipeline
# ---------------------------------------------------------------------------


class SessionPipeline:
    """Executable serve-mode plumbing for one session over a lowered module.

    Built against the *current* program; a hot-swap rebuilds it (at a fully
    drained boundary) and transplants actor state by name.
    """

    def __init__(
        self,
        module: IRModule,
        session: StreamSession,
        device_programs,  # {partition id: DeviceProgram} (or one, or None)
        *,
        controller: str = "am",
        default_depth: int = 4096,
        max_execs_per_invoke: int = 10_000,
        carry_state: Optional[Dict[str, Dict]] = None,
        carry_fifos: Optional[Dict[Tuple, List]] = None,
        recorder=None,
        chaos=None,
    ):
        from repro_torch.runtime.fifo import ArrayFifo

        self.module = module
        self.session = session
        self.max_execs_per_invoke = max_execs_per_invoke
        self.recorder = recorder  # streamtrace (None = untraced server)
        self.chaos = chaos  # fault injection (None = no chaos)
        self._track = f"session:{session.sid}"

        hw_of = module.hw_assignment()
        devset = set(hw_of)
        if device_programs is None:
            device_programs = {}
        elif not isinstance(device_programs, dict):  # legacy single program
            device_programs = {
                getattr(device_programs, "partition", "")
                or device_programs.name: device_programs
            }
        sources = {
            n for n, a in module.actors.items()
            if not a.inputs and n not in devset
        }
        sinks = {
            n for n, a in module.actors.items()
            if not a.outputs and n not in devset
        }
        host = [
            n for n in module.topo_order()
            if n not in devset | sources | sinks
        ]

        # one DeviceStage per device partition — each rides its own
        # batcher lane, so two partitions pipeline inside one session too
        self.stages: Dict[str, DeviceStage] = {
            pid: DeviceStage(device_programs[pid], module)
            for pid in sorted({hw_of[a] for a in devset})
        }
        self.fifos: Dict[Tuple, RingFifo] = {}     # channel key -> fifo
        self.ingress: Dict[str, RingFifo] = {}     # source name -> fifo
        self.egress: List[Tuple[str, RingFifo]] = []  # (sink name, fifo)
        readers: Dict[str, Dict[str, ReaderEndpoint]] = {a: {} for a in host}
        writers: Dict[str, Dict[str, WriterEndpoint]] = {a: {} for a in host}

        for ch in module.channels:
            s_pid, d_pid = hw_of.get(ch.src), hw_of.get(ch.dst)
            if s_pid is not None and s_pid == d_pid:
                continue  # compiled inside one device program
            if s_pid is not None and d_pid is not None:
                # device -> device across partitions: numpy blocks, never
                # per-token Python objects
                f = ArrayFifo(
                    ch.resolved_depth or default_depth,
                    name=f"s{session.sid}:{ch}",
                )
            else:
                f = RingFifo(
                    ch.resolved_depth or default_depth,
                    name=f"s{session.sid}:{ch}",
                    deferred=False,  # one engine thread drives the pipeline
                )
            self.fifos[ch.key] = f
            # writer side
            if ch.src in sources:
                if ch.src in self.ingress:
                    raise ServeError(
                        f"{module.name}: source {ch.src!r} fans out at the "
                        f"graph level; serve mode supports one channel per "
                        f"ingress port"
                    )
                self.ingress[ch.src] = f
            elif s_pid is not None:
                self.stages[s_pid].out_eps[f"{ch.src}.{ch.src_port}"] = (
                    WriterEndpoint(f)
                )
            else:
                writers[ch.src][ch.src_port] = WriterEndpoint(f)
            # reader side
            if ch.dst in sinks:
                self.egress.append((ch.dst, f))
            elif d_pid is not None:
                self.stages[d_pid].in_eps[f"{ch.dst}.{ch.dst_port}"] = (
                    ReaderEndpoint(f)
                )
            else:
                readers[ch.dst][ch.dst_port] = ReaderEndpoint(f)
            # fault-path transplant: a forced swap (partition quarantine) or
            # a checkpoint restore rebuilds the pipeline *with* residual
            # tokens still sitting in host-visible FIFOs.  Residue is keyed
            # by AUTHORED channel key because fusion renames lowered keys
            # differently across placements (``fusedN``/``member__PORT``).
            if carry_fifos:
                residue = carry_fifos.get(
                    authored_channel_key(module, ch.key)
                )
                if residue:
                    f.write(list(residue))
                    f.publish_writer()

        # per-channel totals already folded into server telemetry — the
        # engine records *deltas* periodically, so long-lived sessions feed
        # the online repartitioner too, not just finished ones; transplanted
        # residue starts past the mark (it was already recorded once by the
        # pipeline that originally moved it)
        self._link_marks: Dict[Tuple, int] = {
            key: f.total_written
            for key, f in self.fifos.items()
            if f.total_written
        }

        carry = carry_state or {}
        self.instances: Dict[str, object] = {}
        for name in host:
            impl = module.actors[name].impl
            env = PortEnv(readers[name], writers[name])
            inst = (
                ActorMachine(impl, env)
                if controller == "am"
                else BasicController(impl, env)
            )
            if name in carry:  # hot-swap: persistent actor state survives
                inst.state = carry[name]
            self.instances[name] = inst
        # fused host regions: members collapse into one block executor per
        # group (the member machines stay wrapped inside for tail fallback
        # and state transplant) — the same executor the thread scheduler
        # fires, so serve-mode host rounds get the identical fast path
        self.host_fused: Dict[str, object] = {}
        if module.meta.get("host_fused"):
            from repro_torch.runtime.host_fused import attach_host_fused

            self.host_fused = attach_host_fused(
                module, self.instances, readers, writers, self.fifos
            )
        if carry:
            for stage in self.stages.values():
                stage.state = _transplant_device_state(
                    stage.program, stage.state, carry
                )

        # one admission pump moves at most this many tokens per round — a
        # whole number of source firings keeps multi-token actions intact
        self.pump_quantum = {
            name: math.lcm(
                *(max(r, 1) for _, r in module.actors[name].rate.produces),
                1,
            )
            for name in self.ingress
        }

    # -- engine-side round pieces -------------------------------------------
    def pump(self, telemetry=None) -> int:
        """Admission queues -> ingress FIFOs (bounded by FIFO space).

        Engine-thread only; it owns the queues' reader endpoints, so each
        pump snapshots the client's published writes and publishes its own
        reads back (the deferred cross-thread FIFO protocol)."""
        moved = 0
        for name, fifo in self.ingress.items():
            q = self.session.queues[name]
            quantum = self.pump_quantum[name]
            n = min(self.session.queued_tokens(name), fifo.space())
            n -= n % quantum
            if n <= 0:
                continue
            fifo.write(list(q.read(n)))
            q.publish_reader()  # free the space for blocked submitters
            moved += n
            if telemetry is not None:
                telemetry.queue_depth(q.count())
        return moved

    def host_round(self, telemetry=None) -> int:
        """Fire every host actor machine once (round-robin, like a thread
        partition's fire step).  Fused host regions ride the same list as
        single block-wise instances; their telemetry key carries the member
        list so profile ingestion can split the time back over authored
        actors (``core.profiler.profile_from_telemetry``)."""
        execs = 0
        rec = self.recorder
        ch = self.chaos
        for name, inst in self.instances.items():
            if ch is not None:
                # chaos site: one occurrence per actor invoke per round —
                # ``actor:<name>@s<sid>`` targets one session's actors
                ch.poke(f"actor:{name}@s{self.session.sid}")
            t0 = time.perf_counter_ns()
            e = inst.invoke(self.max_execs_per_invoke)
            if e:
                dt = time.perf_counter_ns() - t0
                key = getattr(inst, "telemetry_key", name)
                if telemetry is not None:
                    telemetry.actor_fired(key, e, dt)
                if rec is not None:
                    # same key/fires/duration as the telemetry record, so a
                    # trace replay reproduces the live actor-time totals
                    rec.complete(
                        self._track, key, "actor", t0, dt, {"fires": e}
                    )
            execs += e
        return execs

    def drain_egress(self) -> int:
        """Egress FIFOs -> session result buffers."""
        moved = 0
        for sink, fifo in self.egress:
            n = fifo.count()
            if n:
                self.session.results[sink].extend(fifo.read(n))
                moved += n
        return moved

    @property
    def stage(self) -> Optional[DeviceStage]:
        """The single device stage (legacy accessor); None when host-only,
        first lane when several."""
        if not self.stages:
            return None
        return next(iter(self.stages.values()))

    def occupancy(self) -> int:
        """Tokens anywhere inside the pipeline (excludes admission queues)."""
        toks = sum(f.occupancy() for f in self.fifos.values())
        for stage in self.stages.values():
            toks += stage.inflight  # in-flight rounds count as occupancy
        return toks

    def quiescent(self) -> bool:
        return self.occupancy() == 0

    def take_link_deltas(self) -> Dict[Tuple, int]:
        """Per-channel tokens moved since the last call (marks advance)."""
        out: Dict[Tuple, int] = {}
        for key, f in self.fifos.items():
            d = f.total_written - self._link_marks.get(key, 0)
            if d:
                out[key] = d
                self._link_marks[key] = f.total_written
        return out

    def carry_state(self) -> Dict[str, Dict]:
        """Actor state to transplant into a rebuilt pipeline (hot-swap)."""
        carry: Dict[str, Dict] = {}
        for n, inst in self.instances.items():
            machines = getattr(inst, "machines", None)
            if machines is not None:  # fused host region: per-member states
                carry.update({m: mach.state for m, mach in machines.items()})
            else:
                carry[n] = inst.state
        for stage in self.stages.values():
            carry.update(_flatten_device_state(stage))
        return carry

    def carry_fifos(self) -> Dict[Tuple, List]:
        """Residual tokens per **authored** channel key (non-consuming).

        The fault-path complement of ``carry_state``: a forced swap cannot
        wait for quiescence (the device that would drain the tokens is the
        thing that failed), so whatever is still sitting in host-visible
        FIFOs is peeked here and written into the rebuilt pipeline's FIFOs
        (`carry_fifos=` on the constructor).  Device-internal channels hold
        no cross-launch tokens (SDF regions launch whole iterations), so
        host FIFOs + admission queues are the complete token residue."""
        out: Dict[Tuple, List] = {}
        for key, f in self.fifos.items():
            n = f.count()
            if n:
                out[authored_channel_key(self.module, key)] = list(f.peek(n))
        return out


# -- device-state transplant across placements ------------------------------


def _flatten_device_state(stage: DeviceStage) -> Dict[str, Dict]:
    """Per-member view of the device state, undoing fusion grouping."""
    flat: Dict[str, Dict] = {}
    fused = stage.program.fused or {}
    for actor, st in stage.state.items():
        members = fused.get(actor)
        if members and set(st) == set(members):
            flat.update({m: dict(s) for m, s in st.items()})
        else:
            flat[actor] = st
    return flat


def _transplant_device_state(program, init, carry: Dict[str, Dict]):
    """Rebuild a device-state tree from carried per-member state where the
    actor names (and state keys) still match; everything else reinitializes."""
    fused = program.fused or {}
    state = {}
    for actor, st in init.items():
        members = fused.get(actor)
        if members and set(st) == set(members):
            state[actor] = {
                m: carry.get(m, st[m])
                if set(carry.get(m, st[m])) == set(st[m]) else st[m]
                for m in st
            }
        else:
            old = carry.get(actor, st)
            state[actor] = old if set(old) == set(st) else st
    return state
