"""StreamServe — a persistent multi-session service over one compiled Program.

``Program.run()`` executes one stream to quiescence and exits; a server for
heavy traffic must instead keep the compiled placement *resident* and run
many client streams through it concurrently.  ``StreamServer`` does that
with one engine thread driving cooperative rounds:

  admission pump   sessions' bounded queues -> ingress FIFOs (backpressure)
  host round       every session's host actor machines fire round-robin
  device dispatch  the continuous batcher packs ready blocks from many
                   sessions into ONE rolling device launch per round —
                   sessions join/leave at block boundaries without draining
                   the in-flight set, lane order decided by a deficit
                   round-robin with a TTFO-histogram boost
                   (``serve_stream.admission.DeficitRoundRobin``)
  egress drain     result FIFOs -> per-session output buffers
  repartition      telemetry feeds the online repartitioner; an accepted
                   XCF is hot-swapped at a fully drained chunk boundary

The swap protocol is drain-and-rebuild: admission pumping stops, in-flight
tokens flow out through the *old* placement, and only when every pipeline
is empty (admission queues — pure untouched client input — excepted) is the
program recompiled and each session's plumbing rebuilt, with actor state
transplanted by name.  No token is dropped or reordered: everything already
admitted left through the old placement in order, everything still queued
enters the new one in order.

Idle behavior uses the runtime's ``AdaptiveBackoff`` + a condition variable
notified by ``submit``/``close``/``stop`` — a parked server burns no core.

Copy of ``repro/serve_stream/engine.py``.  Edit: ``_degrade`` never moves
a partition on a CUDA device to the host — a launch or retire that fails
there fails the partition's live sessions loudly instead.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.observability.recorder import TraceRecorder
from repro_torch.observability.trace_profile import authored_channel_key
from repro_torch.runtime import chaos as chaos_mod
from repro_torch.runtime.scheduler import AdaptiveBackoff
from repro_torch.serve_stream.admission import DeficitRoundRobin
from repro_torch.serve_stream.batcher import DeviceBatcher
from repro_torch.serve_stream.session import (
    ServeError,
    SessionPipeline,
    StreamSession,
)
from repro_torch.serve_stream.telemetry import ServerTelemetry


class StreamServer:
    """Persistent serving runtime over one compiled ``Program``.

    Use as a context manager (or call ``start()``/``stop()``)::

        with prog.serve() as server:
            s = server.open_session()
            s.submit(chunk)           # bounded admission queue
            s.close()
            s.join()
            s.output()                # bit-identical to prog.run()'s stream
    """

    def __init__(
        self,
        program,
        *,
        admission_depth: Optional[int] = None,
        admission_chunk: Optional[int] = None,
        batching: Union[bool, str] = True,
        max_batch: int = 32,
        repartitioner=None,  # OnlineRepartitioner (or None)
        trace: bool = False,
        chaos=None,  # Chaos | spec string | rule list (None: REPRO_CHAOS env)
        checkpoint_dir=None,
        checkpoint_every_s: Optional[float] = None,
        launch_retries: int = 3,
        retry_base_s: float = 0.005,
    ):
        self._program = program
        self._opts = dict(program.opts)
        self.telemetry = ServerTelemetry()
        # streamtrace: one recorder for the server's whole life when
        # ``trace=True`` — session lifecycle instants, host-round actor
        # spans, batched-device dispatch/retire events, channel counters.
        # Export with ``server.trace(path)``.  The numbers recorded are the
        # SAME measured values fed to ``self.telemetry``, so
        # ``snapshot_from_trace`` replays this trace into an identical
        # profile (docs/observability.md).
        self.recorder: Optional[TraceRecorder] = (
            TraceRecorder() if trace else None
        )
        if self.recorder is not None:
            self.recorder.meta.update(
                network=program.graph.name, kind="serve"
            )
        # SLO metrics: per-session time-to-first-output and inter-block
        # delivery latency, plus running service counters — Prometheus
        # exposition via ``metrics_text()``
        self.metrics = MetricsRegistry()
        self._h_ttfo = self.metrics.histogram(
            "serve_ttfo_seconds",
            "first submit to first delivered output, per session",
        )
        self._h_interblock = self.metrics.histogram(
            "serve_interblock_seconds",
            "gap between consecutive output deliveries, per session",
        )
        self._c_delivered = self.metrics.counter(
            "serve_tokens_delivered_total", "tokens delivered to clients"
        )
        self._g_active = self.metrics.gauge(
            "serve_sessions_active", "sessions opened and not yet finished"
        )
        # fault-path metrics (docs/reliability.md): every transition on the
        # retry / degrade / recover paths increments one of these, so a
        # Prometheus scrape sees exactly what the trace instants record
        self._c_faults = self.metrics.counter(
            "serve_faults_total",
            "faults observed while serving: failed device launches, "
            "per-session actor failures, failed checkpoint writes",
        )
        self._c_recoveries = self.metrics.counter(
            "serve_recoveries_total",
            "successful recoveries: launch retries that went through, "
            "partition quarantines that kept sessions alive, sessions "
            "restored from a checkpoint",
        )
        self._g_degraded = self.metrics.gauge(
            "serve_degraded",
            "1 while serving on the all-host fallback placement after a "
            "device partition was quarantined",
        )
        # fault injection: explicit knob wins, else the process env
        # (REPRO_CHAOS / CHAOS_SEED) so chaos smokes need no code changes
        self.chaos = (
            chaos_mod.coerce(chaos) if chaos is not None
            else chaos_mod.from_env()
        )
        self.launch_retries = max(0, launch_retries)
        self.retry_base_s = retry_base_s
        self._quarantined: set = set()
        # checkpointing: explicit ``checkpoint()`` requests always work;
        # checkpoint_dir + checkpoint_every_s adds engine-driven periodic
        # snapshots (each one drains the device lanes — a real boundary)
        self._ckpt_dir = checkpoint_dir
        self._ckpt_every = checkpoint_every_s
        self._ckpt_request: Optional[Dict] = None
        self._ckpt_step = 0
        self._ckpt_last = time.perf_counter()
        self._killed = False
        self.recovery = None  # RecoveryReport when built by recover()
        self.admission_depth = admission_depth or max(
            2 * self._opts["block"], 4096
        )
        # oversized submissions are split into chunks of at most this many
        # tokens at admission (None = one admission queue's worth)
        self.admission_chunk = admission_chunk
        mode = (
            batching if isinstance(batching, str)
            else ("continuous" if batching else "sequential")
        )
        self.mode = "continuous" if mode == "batched" else mode
        self.max_batch = max_batch
        self._sched = DeficitRoundRobin()
        self._ttfo_p95 = 0.0  # cached from the histogram every few rounds
        self.repartitioner = repartitioner
        if repartitioner is not None:
            repartitioner.bind(self)

        module = program.module
        devset = module.hw_actors()
        self.ingress_ports = sorted(
            n for n, a in module.actors.items()
            if not a.inputs and n not in devset
        )
        self.egress_ports = sorted(
            n for n, a in module.actors.items()
            if not a.outputs and n not in devset
        )
        if not self.ingress_ports:
            raise ServeError(
                f"{module.name}: no source actors to serve through — a "
                f"served program needs at least one ingress"
            )

        self._batchers = self._make_batchers()
        self._sessions: List[StreamSession] = []
        self._next_sid = 0
        self._lock = threading.RLock()        # session list + swap requests
        self._wake = threading.Condition()    # work arrival / space freed
        self._pending_xcf = None              # hot-swap request
        self._stop = False
        self._round = 0
        self._thread: Optional[threading.Thread] = None
        self._engine_error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StreamServer":
        if self._thread is not None:
            raise ServeError("server already started")
        self._thread = threading.Thread(
            target=self._engine_main, name="streamserve", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._engine_error is not None:
            err, self._engine_error = self._engine_error, None
            raise err

    def kill(self) -> None:
        """Hard-kill the engine: stop the thread WITHOUT the shutdown flush.

        Simulates a crash for recovery tests and chaos drills — in-flight
        work is abandoned exactly as a process kill would abandon it, and
        sessions are left unfinished (a real crash never sets their
        events).  Recover with ``StreamServer.recover(program, ckpt_dir)``.
        """
        with self._wake:
            self._killed = True
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "StreamServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- checkpoint / recover --------------------------------------------------
    def checkpoint(
        self,
        ckpt_dir,
        *,
        step: Optional[int] = None,
        keep: int = 3,
        timeout: Optional[float] = None,
    ):
        """Write a recoverable snapshot of every session at a drained block
        boundary (client-callable; the engine performs the write between
        rounds, after force-draining the device lanes).  Returns the
        checkpoint path.  See ``serve_stream.recovery`` for the layout and
        ``StreamServer.recover`` for the restore side."""
        from repro_torch.serve_stream import recovery

        with self._lock:
            if step is None:
                self._ckpt_step += 1
                step = self._ckpt_step
            else:
                self._ckpt_step = max(self._ckpt_step, step)
        if self._thread is None:
            # engine not running: this thread owns all state — the
            # boundary is trivially drained
            for b in self._batchers.values():
                b.drain()
            return recovery.write_checkpoint(
                self, ckpt_dir, step=step, keep=keep
            )
        req: Dict = {
            "dir": ckpt_dir, "step": step, "keep": keep,
            "event": threading.Event(), "path": None, "error": None,
        }
        with self._lock:
            self._ckpt_request = req
        self.notify_work()
        if not req["event"].wait(timeout):
            raise ServeError(f"checkpoint to {ckpt_dir} timed out")
        self._check_engine()
        if req["error"] is not None:
            raise ServeError(
                f"checkpoint to {ckpt_dir} failed: {req['error']!r}"
            ) from req["error"]
        return req["path"]

    @classmethod
    def recover(
        cls,
        program,
        ckpt_dir,
        *,
        step: Optional[int] = None,
        start: bool = False,
        **serve_kwargs,
    ) -> "StreamServer":
        """Rebuild a server (and every checkpointed session) from the last
        complete checkpoint under ``ckpt_dir``.

        Each surviving session resumes bit-identically: admission-queue
        residue, FIFO fills, host actor machines and per-partition device
        state are transplanted into fresh pipelines.  The returned server's
        ``.recovery`` is a ``RecoveryReport`` with the per-session replay
        bound (tokens the dead engine may have delivered *after* the
        checkpoint are delivered again — never lost, never reordered).
        Call ``start()`` (or pass ``start=True``) to resume serving."""
        from repro_torch.serve_stream import recovery

        server = recovery.recover(
            program, ckpt_dir, step=step, **serve_kwargs
        )
        return server.start() if start else server

    def serve_opts(self) -> Dict:
        """The construction knobs a recovered server should reuse."""
        return {
            "admission_depth": self.admission_depth,
            "admission_chunk": self.admission_chunk,
            "batching": self.mode,
            "max_batch": self.max_batch,
            "launch_retries": self.launch_retries,
            "retry_base_s": self.retry_base_s,
        }

    # -- client surface --------------------------------------------------------
    @property
    def program(self):
        """The currently served placement (changes on hot-swap)."""
        return self._program

    def open_session(self) -> StreamSession:
        self._check_engine()
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            session = StreamSession(
                sid, self, self.ingress_ports, self.egress_ports,
                self.admission_depth,
            )
            session.pipeline = self._build_pipeline(session)
            self._sessions.append(session)
        self.telemetry.count("sessions_opened")
        self._g_active.add(1)
        if self.recorder is not None:
            self.recorder.instant(
                f"session:{sid}", "session_open", "session"
            )
        self.notify_work()
        return session

    def sessions(self) -> List[StreamSession]:
        """Every session this server knows (recovered ones included)."""
        with self._lock:
            return list(self._sessions)

    def session(self, sid: int) -> StreamSession:
        """Look up one session by id (e.g. after ``recover()``)."""
        with self._lock:
            for s in self._sessions:
                if s.sid == sid:
                    return s
        raise ServeError(f"no session {sid}")

    def request_repartition(self, xcf) -> None:
        """Ask the engine to hot-swap to ``xcf`` at the next chunk boundary."""
        self._check_engine()
        with self._lock:
            self._pending_xcf = xcf
        self.notify_work()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until every opened session has finished."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            sessions = list(self._sessions)
        for s in sessions:
            left = (
                None if deadline is None
                else max(deadline - time.perf_counter(), 0.0)
            )
            if not s.join(left):
                return False
            self._check_engine()
        return True

    # -- observability surface -------------------------------------------------
    def trace(self, path=None) -> Dict:
        """Export the recorded trace as a Chrome-trace payload (optionally
        writing it to ``path``).  Requires ``trace=True`` at construction."""
        if self.recorder is None:
            raise ServeError(
                "server was not constructed with trace=True — nothing was "
                "recorded"
            )
        from repro_torch.observability.chrome import (
            chrome_trace,
            write_chrome_trace,
        )

        payload = chrome_trace(self.recorder)
        if path is not None:
            write_chrome_trace(payload, path)
        return payload

    def metrics_text(self) -> str:
        """The metrics registry in Prometheus text exposition format."""
        return self.metrics.expose_text()

    # -- engine plumbing (called from session/client threads) ----------------
    def notify_work(
        self, chunks: int = 0, tokens: int = 0, split: int = 0
    ) -> None:
        if chunks or tokens:
            # both counters under one telemetry lock: a snapshot() racing
            # this client thread must never split one submission's chunk
            # and token counts across two windows
            self.telemetry.submitted(chunks, tokens, split=split)
        with self._wake:
            self._wake.notify_all()

    def wait_for_space(self, deadline: Optional[float]) -> bool:
        """Block a submitting client until the engine frees admission space
        (or the deadline passes).  Engine liveness is re-checked so a dead
        engine cannot strand clients."""
        self._check_engine()
        if self._thread is None:
            raise ServeError(
                "server not started: admission queue full and nothing is "
                "draining it"
            )
        with self._wake:
            timeout = 0.05 if deadline is None else min(
                max(deadline - time.perf_counter(), 0.0), 0.05
            )
            self._wake.wait(timeout)
        if deadline is not None and time.perf_counter() >= deadline:
            return False
        return True

    def _check_engine(self) -> None:
        if self._engine_error is not None:
            raise ServeError(
                f"serving engine died: {self._engine_error!r}"
            ) from self._engine_error

    # -- engine internals ------------------------------------------------------
    def _make_batchers(self) -> Dict[str, DeviceBatcher]:
        """One independent ``DeviceBatcher`` per device partition — each
        lane keeps its own in-flight dispatches, so two accelerator
        partitions pipeline against each other across all sessions."""
        return {
            pid: DeviceBatcher(
                dp, mode=self.mode, max_batch=self.max_batch,
                telemetry=self.telemetry, recorder=self.recorder,
                chaos=self.chaos,
            )
            for pid, dp in self._program.device_programs().items()
        }

    def _build_pipeline(
        self,
        session: StreamSession,
        carry: Optional[Dict] = None,
        carry_fifos: Optional[Dict] = None,
    ) -> SessionPipeline:
        return SessionPipeline(
            self._program.module,
            session,
            self._program.device_programs(),
            controller=self._opts["controller"],
            default_depth=self._opts["default_depth"],
            max_execs_per_invoke=self._opts["max_execs_per_invoke"],
            carry_state=carry,
            carry_fifos=carry_fifos,
            recorder=self.recorder,
            chaos=self.chaos,
        )

    def _engine_main(self) -> None:
        try:
            self._engine_loop()
        except BaseException as e:  # noqa: BLE001 — surfaced to clients
            # Infrastructure faults ONLY: per-session failures (one actor
            # raising, one stream's bad input) are isolated inside the loop
            # by ``_fail_session`` and never reach here — engine death is
            # reserved for faults no session caused (docs/reliability.md).
            self._engine_error = e
            # fail every waiter loudly rather than hanging them — and make
            # sure output() raises instead of returning a truncated stream
            with self._lock:
                for s in self._sessions:
                    if not s.finished.is_set():
                        s.error = s.error or (
                            f"serving engine died mid-stream: {e!r}"
                        )
                        s.finished.set()
                req, self._ckpt_request = self._ckpt_request, None
            if req is not None and req.get("event") is not None:
                req["error"] = req["error"] or e
                req["event"].set()
            with self._wake:
                self._wake.notify_all()

    def _engine_loop(self) -> None:
        backoff = AdaptiveBackoff(first=50e-6, cap=5e-3)
        dev_backoff = AdaptiveBackoff(first=20e-6, cap=1e-3)
        while True:
            with self._wake:
                if self._stop:
                    break
            with self._lock:
                active = [s for s in self._sessions if not s.finished.is_set()]
                swapping = self._pending_xcf is not None
            moved = 0
            self._round += 1
            if self._round % 128 == 1:
                # refresh the scheduler's view of the TTFO tail — the
                # histogram walk is too costly to run every round
                self._ttfo_p95 = self._h_ttfo.percentile(95)

            # 1) admission pump (paused while a swap is draining).  Every
            # per-session step is blast-radius isolated: ONE stream's
            # failure (its actor raising, its bad input) fails that
            # session — with the captured traceback delivered to its
            # client — and the engine keeps serving everyone else.
            if not swapping:
                for s in active:
                    moved += self._guarded(
                        s, s.pipeline.pump, "admission pump",
                        self.telemetry,
                    )
            if moved:
                with self._wake:  # free space -> unblock submitters
                    self._wake.notify_all()

            # 2) host actors
            for s in active:
                moved += self._guarded(
                    s, s.pipeline.host_round, "host round", self.telemetry
                )

            # 3) device lanes: per partition, retire what finished, then
            # launch one continuous round from whatever is ready — riding an
            # in-flight round does not disqualify a stage (state chains
            # through the launch's output future), and the deficit
            # round-robin decides who gets the max_batch lanes.  Partitions
            # are independent, so partition A's next round goes out while
            # partition B's is still in flight.
            pending_device = False
            degrade: Optional[Tuple[str, BaseException]] = None
            now_ns = time.perf_counter_ns()
            for pid, batcher in self._batchers.items():
                try:
                    moved += batcher.poll()
                except Exception as e:  # retire failed: rounds are lost
                    self._poll_failed(pid, batcher, e)
                    degrade = (pid, e)
                    break
                cands = []
                for s in active:
                    if s.finished.is_set():
                        continue
                    stage = s.pipeline.stages.get(pid)
                    if stage is not None and stage.ready_tokens() > 0:
                        cands.append((s, stage))
                if cands and batcher.can_launch():
                    ordered = self._sched.order(
                        cands, now_ns=now_ns, ttfo_p95_s=self._ttfo_p95
                    )
                    before = [
                        (s, st, st.tokens_staged) for s, st in ordered
                    ]
                    lanes, fatal = self._launch_with_retry(
                        pid, batcher, [st for _s, st in ordered]
                    )
                    moved += lanes
                    for s, st, t0 in before:
                        d = st.tokens_staged - t0
                        if d:
                            self._sched.charge(s.sid, d, self._round)
                    if fatal is not None:
                        degrade = (pid, fatal)
                        break
                pending_device = pending_device or batcher.pending
            if degrade is not None:
                # retry exhausted (or retire died): quarantine the
                # partition and swap every live session to the all-host
                # placement — serving degrades, it does not die
                self._degrade(*degrade)
                continue

            # 4) egress
            for s in active:
                if s.finished.is_set():
                    continue
                n = self._guarded(
                    s, s.pipeline.drain_egress, "egress drain"
                )
                if n:
                    self.telemetry.count("tokens_delivered", n)
                    self._observe_delivery(s, n)
                moved += n

            # 5) session completion
            for s in active:
                if s.finished.is_set():
                    continue
                if (
                    s.closed
                    and all(s.queued_tokens(n) == 0 for n in s.queues)
                    and s.pipeline.quiescent()
                ):
                    self._record_links(s.pipeline)
                    s.finished.set()
                    self._session_closed(s)
                    with self._wake:
                        self._wake.notify_all()

            # 5b) checkpoint: explicit requests and the periodic schedule
            # both write at this point — after completion, before swaps —
            # with the device lanes force-drained first (a real block
            # boundary; see serve_stream.recovery)
            with self._lock:
                req, self._ckpt_request = self._ckpt_request, None
            if req is None and self._ckpt_dir is not None \
                    and self._ckpt_every is not None:
                now = time.perf_counter()
                if now - self._ckpt_last >= self._ckpt_every:
                    self._ckpt_last = now
                    with self._lock:
                        self._ckpt_step += 1
                        step = self._ckpt_step
                    req = {
                        "dir": self._ckpt_dir, "step": step, "keep": 3,
                        "event": None, "path": None, "error": None,
                    }
            if req is not None:
                self._write_checkpoint(req)

            # 6) swap / repartition bookkeeping (the repartitioner is
            # ignored while degraded: the quarantined device must not be
            # re-proposed by a MILP that cannot see it is dead)
            if swapping and not pending_device:
                if all(
                    s.pipeline.quiescent()
                    for s in active if not s.finished.is_set()
                ):
                    self._do_swap()
                    continue
            if (
                self.repartitioner is not None
                and not swapping
                and not self._quarantined
            ):
                # flush live sessions' link deltas into the window first, so
                # the MILP sees channel traffic from still-open streams too
                if self._round % 32 == 0:
                    for s in active:
                        self._record_links(s.pipeline)
                xcf = self.repartitioner.maybe()
                if xcf is not None:
                    with self._lock:
                        self._pending_xcf = xcf

            # 7) park when idle — adaptive: a short ramp while a device step
            # is in flight (poll it soon), a CV wait when truly idle (only a
            # submit/close/stop can create work, and each notifies)
            if moved == 0:
                if pending_device:
                    dev_backoff.pause()
                elif self._stall_check(active, swapping):
                    continue
                else:
                    with self._wake:
                        if not self._stop:
                            self._wake.wait(
                                max(backoff.next_timeout(), 1e-4)
                            )
            else:
                backoff.reset()
                dev_backoff.reset()

        if self._killed:
            # hard-kill (crash simulation): no flush, no completion — the
            # recovery path must work from whatever the last checkpoint
            # captured, exactly as it would after a process kill
            return
        # shutdown: flush anything still in flight so state stays consistent
        for batcher in self._batchers.values():
            batcher.drain()
        # ...and flush egress: the drain above retires tokens into FIFOs
        # *behind* the egress drain of the loop's last round, possibly with
        # host actors still between them — without this, tokens retired
        # during stop would never reach session output buffers
        with self._lock:
            sessions = list(self._sessions)
        progressed = True
        while progressed:
            progressed = False
            for s in sessions:
                if s.pipeline is None or s.error is not None:
                    continue
                if self._guarded(
                    s, s.pipeline.host_round, "shutdown flush",
                    self.telemetry,
                ):
                    progressed = True
                n = self._guarded(
                    s, s.pipeline.drain_egress, "shutdown flush"
                )
                if n:
                    self.telemetry.count("tokens_delivered", n)
                    self._observe_delivery(s, n)
                    progressed = True

    # -- fault paths: isolate, retry, degrade ---------------------------------
    def _fault_instant(self, name: str, **args) -> None:
        """Trace instant for one fault-path transition (engine track)."""
        if self.recorder is not None:
            self.recorder.instant("engine", name, "engine", args or None)

    def _guarded(self, s: StreamSession, fn, where: str, *args) -> int:
        """Run one session's round step; a failure fails THAT session."""
        if s.finished.is_set():
            return 0
        try:
            return fn(*args)
        except Exception as e:
            self._fail_session(s, e, where)
            return 0

    def _fail_session(
        self, s: StreamSession, exc: BaseException, where: str
    ) -> None:
        """Blast-radius isolation: mark one session failed (captured
        traceback delivered to its client via ``output()``/``error``),
        keep the engine and every other session running."""
        if s.finished.is_set():
            return
        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
        s.error = (
            f"session {s.sid} failed during {where}: {exc!r}\n{tb}"
        )
        self._c_faults.inc()
        self._fault_instant(
            "session_fault", sid=s.sid, where=where, error=repr(exc)
        )
        try:
            self._record_links(s.pipeline)
        except Exception:  # noqa: BLE001 — already on the failure path
            pass
        s.finished.set()
        self._session_closed(s)
        with self._wake:
            self._wake.notify_all()

    def _launch_with_retry(
        self, pid: str, batcher: DeviceBatcher, stages: List
    ) -> Tuple[int, Optional[BaseException]]:
        """Bounded exponential-backoff retry around one device launch.

        The chaos/fault site sits at launch *entry*, before any staging, so
        a failed attempt leaves every FIFO and stage untouched and the
        retry replays the identical round — transient faults cost latency,
        never tokens.  Returns ``(lanes, None)`` on success or ``(0, err)``
        when the partition looks persistently dead (degrade next)."""
        delay = self.retry_base_s
        for attempt in range(self.launch_retries + 1):
            try:
                lanes = batcher.launch(stages)
            except Exception as e:  # noqa: PERF203 — the retry loop IS the point
                self._c_faults.inc()
                self._fault_instant(
                    "launch_fault", partition=pid, attempt=attempt,
                    error=repr(e),
                )
                if attempt == self.launch_retries:
                    return 0, e
                time.sleep(delay)
                delay = min(delay * 2.0, 0.25)
            else:
                if attempt:
                    # a retry went through: the fault was transient
                    self._c_recoveries.inc()
                    self._fault_instant(
                        "launch_retry_ok", partition=pid, attempt=attempt
                    )
                return lanes, None
        return 0, None  # unreachable; keeps type checkers honest

    def _poll_failed(
        self, pid: str, batcher: DeviceBatcher, exc: BaseException
    ) -> None:
        """A retire failed: the partition's in-flight rounds are gone.
        Their riders lose tokens — fail those sessions loudly (never
        silently truncate a stream), then let the caller degrade."""
        self._c_faults.inc()
        self._fault_instant(
            "retire_fault", partition=pid, error=repr(exc),
            lost_rounds=len(batcher.inflight),
        )
        lost = {
            id(st) for entry in batcher.inflight for st in entry.riders
        }
        batcher.inflight.clear()
        if not lost:
            return
        with self._lock:
            sessions = list(self._sessions)
        for s in sessions:
            if s.finished.is_set() or s.pipeline is None:
                continue
            if any(
                id(st) in lost for st in s.pipeline.stages.values()
            ):
                st = s.pipeline.stages.get(pid)
                if st is not None:
                    st.inflight = 0
                self._fail_session(
                    s, exc,
                    f"device retire on partition {pid!r} (in-flight "
                    f"tokens lost)",
                )

    def _degrade(self, pid: str, exc: BaseException) -> None:
        """Quarantine a persistently failing device partition and hot-swap
        every live session onto the all-host placement (forced: the dead
        device cannot drain, so FIFO residue is transplanted by authored
        channel key instead of waiting for quiescence).  Serving continues
        degraded — host execution is bit-identical to the device path
        (the conformance invariant), so clients only see latency."""
        from repro_torch.frontend.program import synthesize_xcf

        if pid in self._quarantined:
            return
        device = self._batchers[pid].program.device
        if device.type == "cuda":
            # the partition's tensors live on the card: the host placement
            # would compute what the card was asked to, so fail its live
            # sessions instead of serving them somewhere else
            with self._lock:
                sessions = list(self._sessions)
            for s in sessions:
                if s.pipeline is not None and pid in s.pipeline.stages:
                    self._fail_session(
                        s, exc, f"device launch on partition {pid!r} ({device})"
                    )
            return
        self._quarantined.add(pid)
        self._g_degraded.set(1.0)
        self._fault_instant("degrade", partition=pid, error=repr(exc))
        xcf = synthesize_xcf(self._program.graph, "host")
        self._do_swap(xcf=xcf, forced=True)
        # the swap kept every live session's tokens: that is a recovery
        self._c_recoveries.inc()

    def _write_checkpoint(self, req: Dict) -> None:
        """Engine-side checkpoint write at a drained boundary."""
        from repro_torch.serve_stream import recovery

        try:
            for b in self._batchers.values():
                b.drain()
            req["path"] = recovery.write_checkpoint(
                self, req["dir"], step=req["step"], keep=req["keep"]
            )
            self._fault_instant("checkpoint", step=req["step"])
        except Exception as e:  # noqa: BLE001 — surfaced to the requester
            self._c_faults.inc()
            self._fault_instant(
                "checkpoint_fault", step=req["step"], error=repr(e)
            )
            req["error"] = e
        finally:
            if req["event"] is not None:
                req["event"].set()

    def _stall_check(
        self, active: List[StreamSession], swapping: bool
    ) -> bool:
        """Detect closed sessions that can never finish: residual tokens
        below some consumption quantum (a torn stream tail) — stuck either
        in the pipeline or still in the admission queue (the pump also only
        moves whole source firings).  Marks them failed instead of hanging
        ``join()`` forever.

        Only called when the whole engine round made no progress, so any
        remaining occupancy is provably stuck: host actors just declined to
        fire and the device stage (if any) has nothing stageable and
        nothing in flight.  During a swap the pump is paused, so queued
        tokens are not evidence of a stall."""
        hit = False
        for s in active:
            if not s.closed:
                continue
            queued = {n: s.queued_tokens(n) for n in s.queues}
            if any(queued.values()):
                if swapping:
                    continue  # pump paused; the swap will resume it
                # a whole pump quantum is still queued: pump will move it
                # next round (this round may have raced the submit)
                if any(
                    q >= s.pipeline.pump_quantum[n]
                    for n, q in queued.items()
                    if q
                ):
                    continue
            elif s.pipeline.quiescent():
                continue  # normal completion (step 5) handles this
            stages = list(s.pipeline.stages.values())
            if any(st.pending or st._plan() for st in stages):
                continue  # device work still possible
            quanta = {}
            for st in stages:
                quanta.update(st.quantum)
            stuck = s.pipeline.occupancy() + sum(queued.values())
            # per-fifo fill levels: the same picture runtime.stall paints
            # for scheduler runs, so a torn tail names the exact channel
            fills = {
                "->".join(map(str, key[::2])): f.occupancy()
                for key, f in s.pipeline.fifos.items()
                if f.occupancy() > 0
            }
            fills.update(
                {f"queue:{n}": q for n, q in queued.items() if q}
            )
            s.error = (
                f"session {s.sid}: stream ended with {stuck} tokens stuck "
                f"below a consumption quantum "
                f"{quanta or '(host actor rates)'} — submit whole "
                f"iterations (e.g. multiples of 8 for an 8-point "
                f"transform); stuck tokens by fifo: {fills or '{}'}"
            )
            self._record_links(s.pipeline)
            s.finished.set()
            self._session_closed(s)
            with self._wake:
                self._wake.notify_all()
            hit = True
        return hit

    def _session_closed(self, s: StreamSession) -> None:
        self.telemetry.count("sessions_closed")
        self._sched.forget(s.sid)
        self._g_active.add(-1)
        if self.recorder is not None:
            self.recorder.instant(
                f"session:{s.sid}", "session_close", "session",
                {"error": bool(s.error)},
            )

    def _observe_delivery(self, s: StreamSession, n: int) -> None:
        """Per-session SLO accounting at the moment tokens reach the client
        buffer: TTFO on the first delivery, inter-block gap on every later
        one, plus the trace's ``deliver`` instant."""
        now = time.perf_counter_ns()
        self._c_delivered.inc(n)
        if s.first_delivery_ns is None:
            s.first_delivery_ns = now
            if s.first_submit_ns is not None:
                self._h_ttfo.observe((now - s.first_submit_ns) / 1e9)
        elif s.last_delivery_ns is not None:
            self._h_interblock.observe((now - s.last_delivery_ns) / 1e9)
        s.last_delivery_ns = now
        if self.recorder is not None:
            self.recorder.instant(
                f"session:{s.sid}", "deliver", "session", {"tokens": n}
            )

    def _record_links(self, pipeline: SessionPipeline) -> None:
        """Fold a pipeline's per-channel token movement since the last
        recording into telemetry (authored-graph keys, so profile ingestion
        feeds the MILP).  Delta-based: safe to call repeatedly — the engine
        does so periodically for live sessions and once more at
        completion/stall/swap."""
        module = pipeline.module
        rec = self.recorder
        for key, delta in pipeline.take_link_deltas().items():
            src, sp, dst, dp = authored_channel_key(module, key)
            self.telemetry.link_moved((src, sp, dst, dp), delta)
            if rec is not None:
                # identical delta + authored key as telemetry, so the trace
                # replays into the same per-link token totals
                rec.counter(
                    "channels", f"{src}.{sp}->{dst}.{dp}", delta,
                    cat="channel",
                    args={
                        "src": src, "src_port": sp,
                        "dst": dst, "dst_port": dp,
                    },
                )

    # -- the hot swap ----------------------------------------------------------
    def _do_swap(self, xcf=None, forced: bool = False) -> None:
        """Recompile onto ``xcf`` and rebuild every live pipeline.

        The planned path (``xcf=None``: take the pending request) runs at a
        fully drained boundary, so actor state is the only thing to
        transplant.  A **forced** swap (partition quarantine) cannot wait
        for quiescence — the device that would drain the tokens is the
        thing that failed — so healthy lanes are force-drained, a dead
        lane's in-flight rounds are retired if the device still answers
        (riders fail loudly only when retirement itself raises), and
        whatever still sits in host-visible FIFOs is transplanted by
        authored channel key alongside the actor state."""
        with self._lock:
            if xcf is None:
                xcf = self._pending_xcf
                self._pending_xcf = None
            else:
                self._pending_xcf = None  # a forced swap overrides a plan
            if xcf is None:
                return
            old = self._program
            old_assignment = old.xcf.assignment()
            # record what the old placement moved before its pipelines die
            for s in self._sessions:
                if not s.finished.is_set():
                    self._record_links(s.pipeline)
            if forced:
                for pid, b in self._batchers.items():
                    if pid in self._quarantined and b.inflight:
                        # a quarantined lane's in-flight rounds were already
                        # dispatched — a partition that stopped *accepting*
                        # launches usually still retires them, so try that
                        # first (no tokens lost); fail the riders loudly
                        # only when retirement itself is broken
                        try:
                            b.drain()
                        except Exception as e:  # noqa: BLE001
                            self._poll_failed(pid, b, e)
                    elif pid not in self._quarantined:
                        b.drain()
            self._program = old.repartition(xcf=xcf)
            self._batchers = self._make_batchers()
            for s in self._sessions:
                if s.finished.is_set():
                    continue
                carry = s.pipeline.carry_state()
                residue = s.pipeline.carry_fifos() if forced else None
                s.pipeline = self._build_pipeline(
                    s, carry=carry, carry_fifos=residue
                )
        self.telemetry.swapped({
            "from": old_assignment,
            "to": self._program.xcf.assignment(),
            "network": self._program.graph.name,
        })
        if self.recorder is not None:
            self.recorder.instant(
                "engine", "hot_swap", "engine",
                {
                    "to": self._program.xcf.assignment(),
                    "forced": forced,
                },
            )
        self.notify_work()
