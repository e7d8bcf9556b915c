"""One-call compile pipeline: ``repro_torch.compile(net, xcf) -> Program``.

The paper's promise is that *placement is configuration*: the same dataflow
program runs on host threads, the device partition, or a mix, selected by an
XCF (§III-A) — recompiling with new directives is the whole design-space
exploration loop.  ``Program`` makes that loop one method call each:

    prog = repro_torch.compile(net)                  # host-only by default
    report = prog.run()                        # execute, collect stats
    prof = prog.profile()                      # MILP inputs (§III-E)
    points = prog.explore(prof)                # solve the placement MILP
    best = prog.repartition(points and best_point(points).xcf)
    best.run()                                 # same graph, new placement

Compilation runs the middle-end pass pipeline (``repro_torch.ir``): the authored
network is lowered to a typed IR module — placement legalized, dead actors
eliminated, FIFO depths inferred, SDF device regions fused — and every
backend consumes that module.  ``Program.ir_dump()`` shows the module after
each pass; the authored network is never mutated by a placement change.

Port of ``repro/frontend/program.py``.  ``compile(..., device=)`` names the
torch device the hw partitions run on (default ``cuda:0``; an XCF ``pe`` of
``"gpu:<i>"``/``"cuda:<i>"``/``"cpu"`` picks its own).  A placement with a hw
partition on CUDA raises when no card is present — it never quietly runs on
the CPU.  ``serve()``, ``profile()`` and ``explore()`` arrive with later
slices of the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from repro_torch.core.graph import ActorGraph
from repro_torch.core.xcf import XCF, make_xcf
from repro_torch.frontend.dsl import FrontendError, Network
from repro_torch.ir.ir import IRModule
from repro_torch.ir.passes import lower
from repro_torch.observability.recorder import TraceRecorder, activate
from repro_torch.runtime.scheduler import DEFAULT_DEPTH, HeteroRuntime, HostRuntime

BACKENDS = ("auto", "host", "threads", "device")


def _as_graph(net: Union[Network, ActorGraph]) -> ActorGraph:
    if isinstance(net, Network):
        return net.graph()
    if isinstance(net, ActorGraph):
        net.validate()
        return net
    raise FrontendError(
        f"compile() expects a frontend Network or a core ActorGraph, "
        f"got {type(net).__name__}"
    )


def synthesize_xcf(
    graph: ActorGraph,
    backend: str = "host",
    *,
    threads: Optional[int] = None,
    accel: str = "accel",
) -> XCF:
    """Produce a placement configuration without running the partitioner.

    ``host``    — every actor on one software thread,
    ``threads`` — round-robin over ``threads`` software threads (default: one
                  thread per actor, the paper's "many" corner),
    ``device``  — every device-eligible actor on the accelerator partition,
                  IO/host-only actors round-robin over ``threads`` software
                  threads (default one) so host-side rate conversion can
                  overlap the device pipeline.
    """
    if backend == "host":
        assignment = {a: "t0" for a in graph.actors}
    elif backend == "threads":
        order = graph.topo_order()
        n = len(order) if threads is None else max(1, threads)
        assignment = {a: f"t{i % n}" for i, a in enumerate(order)}
    elif backend == "device":
        eligible = [a for a, act in graph.actors.items() if act.device_ok]
        if not eligible:
            reasons = {
                a: act.host_only_reason or "host-only"
                for a, act in graph.actors.items()
            }
            raise FrontendError(
                f"backend='device': no device-eligible actors in "
                f"{graph.name!r} ({reasons})"
            )
        n = 1 if threads is None else max(1, threads)
        hosted = [
            a for a in graph.topo_order()
            if not graph.actors[a].device_ok
        ]
        thread_of = {a: f"t{i % n}" for i, a in enumerate(hosted)}
        assignment = {
            a: (accel if act.device_ok else thread_of[a])
            for a, act in graph.actors.items()
        }
    else:
        raise FrontendError(
            f"unknown backend {backend!r}; choose from {BACKENDS[1:]} "
            f"or pass an explicit xcf"
        )
    return make_xcf(graph.name, assignment, accel=accel)


def _load_xcf(xcf: Union[XCF, str, Path]) -> XCF:
    if isinstance(xcf, (str, Path)):
        return XCF.load(xcf)
    if isinstance(xcf, XCF):
        return xcf
    raise FrontendError(f"expected an XCF or a path to one, got {type(xcf).__name__}")


@dataclass
class RunReport:
    """What one ``Program.run()`` observed."""

    network: str
    backend: str                      # "host(n threads)" | "hetero(accel)"
    seconds: float
    fires: int
    actor_fires: Dict[str, int]
    actor_tests: Dict[str, int]       # controller condition tests (paper §IV)
    channel_tokens: Dict[str, int]
    plink_launches: int = 0
    plink_tokens_out: int = 0
    # Chrome-trace payload when the run was traced (``run(trace=...)``);
    # feed it to ``repro_torch.observability`` validators or
    # ``core.profiler.profile_from_trace`` for offline DSE
    trace: Optional[Dict] = None

    @property
    def tests(self) -> int:
        return sum(self.actor_tests.values())

    def __str__(self) -> str:
        extra = (
            f" plink_launches={self.plink_launches}"
            if self.plink_launches
            else ""
        )
        return (
            f"{self.network}: {self.backend} {self.seconds * 1e3:.1f}ms "
            f"{self.fires} fires{extra}"
        )


class Program:
    """An executable placement of a dataflow network.

    Immutable pairing of (network, XCF, runtime options).  Compilation lowers
    the network through the pass pipeline into ``self.module`` — the typed IR
    every backend consumes; ``repartition`` re-runs the pipeline with a new
    XCF and returns a *new* Program over the same authored network, which is
    never rebuilt or mutated by a placement change.
    """

    def __init__(
        self,
        source: Union[Network, ActorGraph],
        graph: ActorGraph,
        xcf: XCF,
        *,
        controller: str = "am",
        block: int = 1024,
        default_depth: int = DEFAULT_DEPTH,
        max_execs_per_invoke: int = 10_000,
        fuse: bool = True,
        opt_level: int = 1,
        check: object = True,
        megastep: object = "auto",
        device=None,
    ):
        self._source = source
        self._graph = graph
        self._xcf = xcf
        self._opts = dict(
            controller=controller,
            block=block,
            default_depth=default_depth,
            max_execs_per_invoke=max_execs_per_invoke,
            fuse=fuse,
            opt_level=opt_level,
            check=check,
            megastep=megastep,
            device=device,
        )
        self._device = torch.device("cuda:0" if device is None else device)
        # The middle-end: every placement check, depth resolution, and fusion
        # decision happens here, once per (graph, xcf, opts) triple.
        self._module = lower(
            graph,
            xcf,
            default_depth=default_depth,
            block=block,
            fuse=fuse,
            opt_level=opt_level,
            check=check,
            megastep=megastep,
        )
        from repro_torch.runtime.device_runtime import resolve_pe_device

        for r in self._module.hw_regions():
            dev = resolve_pe_device(r.pe, self._device)
            if r.actors and dev.type == "cuda" and not torch.cuda.is_available():
                raise FrontendError(
                    f"{graph.name}: hw partition {r.id!r} runs on {dev}, but "
                    f"CUDA is not available; pass device='cpu' to run the "
                    f"device partitions on the CPU"
                )
        # device partitions, built lazily and reused across run() calls (the
        # (graph, xcf, opts) triple is fixed for this Program's lifetime):
        # {partition id: DeviceProgram}
        self._device_programs: Optional[Dict[str, object]] = None

    # -- introspection ---------------------------------------------------------
    @property
    def graph(self) -> ActorGraph:
        return self._graph

    @property
    def opts(self) -> Dict:
        """The runtime options this Program was compiled with (a copy)."""
        return dict(self._opts)

    @property
    def module(self) -> IRModule:
        """The lowered IR this Program executes."""
        return self._module

    @property
    def network(self) -> Optional[Network]:
        return self._source if isinstance(self._source, Network) else None

    @property
    def xcf(self) -> XCF:
        return self._xcf

    @property
    def hw_partition(self) -> Optional[str]:
        """The single device partition's id (first lane when several)."""
        hw = self.hw_partitions
        return hw[0] if hw else None

    @property
    def hw_partitions(self) -> list:
        """Every device partition id, in stable (id-sorted) order."""
        return [r.id for r in self._module.hw_regions() if r.actors]

    def ir_dump(self, pass_name: Optional[str] = None) -> str:
        """The module after every pass (or after ``pass_name`` only) — the
        compiler's pass-by-pass story for this placement."""
        return self._module.dump_trace(pass_name)

    def check(self):
        """The streamcheck findings for this Program (``Diagnostics``).

        Returns the diagnostics collected at compile time; when analysis was
        skipped (``check=False``), runs the full suite now under the
        warn-and-continue policy — ``Program.check()`` itself never raises,
        it reports.  See docs/analysis.md for the ``SB###`` catalog.
        """
        from repro_torch.analysis import check_module

        diags = self._module.meta.get("diagnostics")
        if diags is None:
            diags = check_module(self._module, block=self._opts["block"])
        return diags

    @property
    def repetition_vector(self) -> Optional[Dict[str, int]]:
        """Fires-per-iteration per actor from the rate analysis (None when
        analysis was skipped and ``check()`` has not been called)."""
        rep = self._module.meta.get("repetition")
        return dict(rep) if rep is not None else None

    def describe(self) -> str:
        asg = self._xcf.assignment()
        lines = [f"Program {self._graph.name}"]
        for pid, spec in sorted(self._xcf.partitions.items()):
            lines.append(
                f"  {pid} [{spec.code_generator}/{spec.pe}]: "
                f"{', '.join(sorted(a for a, p in asg.items() if p == pid))}"
            )
        return "\n".join(lines)

    # -- execution -------------------------------------------------------------
    def device_programs(self) -> Dict[str, object]:
        """The compiled device partitions, ``{partition id:
        DeviceProgram}`` — empty for host-only placements.  Compiled on
        first use and cached for this Program."""
        if self._device_programs is None:
            from repro_torch.runtime.device_runtime import compile_hw_partitions

            self._device_programs = compile_hw_partitions(
                self._module, block=self._opts["block"], device=self._device
            )
        return self._device_programs

    def device_program(self):
        """The compiled device partition for single-partition placements
        (None when host-only).  Multi-partition programs must use
        ``device_programs()`` — there is no single 'the' partition."""
        programs = self.device_programs()
        if not programs:
            return None
        if len(programs) > 1:
            raise FrontendError(
                f"{self._graph.name}: {len(programs)} device partitions "
                f"({sorted(programs)}); use device_programs()"
            )
        return next(iter(programs.values()))

    def _build_runtime(self):
        if self.hw_partitions:
            rt = HeteroRuntime(
                self._module,
                block=self._opts["block"],
                controller=self._opts["controller"],
                default_depth=self._opts["default_depth"],
                max_execs_per_invoke=self._opts["max_execs_per_invoke"],
                programs=self.device_programs(),
                device=self._device,
            )
        else:
            rt = HostRuntime(
                self._module,
                controller=self._opts["controller"],
                default_depth=self._opts["default_depth"],
                max_execs_per_invoke=self._opts["max_execs_per_invoke"],
            )
        return rt

    def _reset_collectors(self) -> None:
        if isinstance(self._source, Network):
            for lst in self._source.collectors:
                lst.clear()

    def run(
        self,
        *,
        threaded: Optional[bool] = None,
        reset_collectors: bool = True,
        trace: Union[None, bool, str, Path] = None,
    ) -> RunReport:
        """Execute to quiescence on the placement the XCF describes.

        ``trace`` turns on streamtrace recording for this run: pass a path
        to also write the Chrome-trace JSON there, or ``True`` to only
        attach the payload to ``RunReport.trace``.  The exported trace has
        one track per scheduler thread (actor-firing spans), per PLink lane
        (stage/dispatch/sync/retire phase spans), plus run-level and
        channel-token events — openable in Perfetto / ``chrome://tracing``
        and replayable through ``core.profiler.profile_from_trace``.
        """
        if reset_collectors:
            self._reset_collectors()
        rec = TraceRecorder() if trace else None
        if rec is not None:
            rec.meta.update(network=self._graph.name, kind="run")
        with activate(rec):
            rt = self._build_runtime()
            hetero = isinstance(rt, HeteroRuntime)
            t0 = time.perf_counter()
            if hetero:
                rt.run_threads()
            elif threaded is None:
                rt.run()
            elif threaded:
                rt.run_threads()
            else:
                rt.run_single()
            seconds = time.perf_counter() - t0
        n_sw = len(rt.partitions)
        backend = (
            f"hetero({'+'.join(self.hw_partitions)}+{n_sw}thr)" if hetero
            else f"host({n_sw}thr)"
        )
        payload = None
        if rec is not None:
            from repro_torch.observability.chrome import (
                chrome_trace,
                write_chrome_trace,
            )

            rt.record_channel_totals()
            rec.meta["backend"] = backend
            payload = chrome_trace(rec)
            if not isinstance(trace, bool):
                write_chrome_trace(payload, trace)
        return RunReport(
            network=self._graph.name,
            backend=backend,
            seconds=seconds,
            fires=rt.total_fires(),
            actor_fires={a: p.fires for a, p in rt.profiles.items()},
            actor_tests={a: p.tests for a, p in rt.profiles.items()},
            channel_tokens=rt.channel_tokens(),
            plink_launches=(
                sum(p.stats.launches for p in rt.plinks.values())
                if hetero else 0
            ),
            plink_tokens_out=(
                sum(p.stats.tokens_out for p in rt.plinks.values())
                if hetero else 0
            ),
            trace=payload,
        )

    # -- later slices of the port ------------------------------------------------
    def serve(self, **_kw):
        """Multi-session serving arrives with the serving port."""
        raise NotImplementedError(
            "repro_torch: Program.serve() is not ported yet (ROADMAP A7, "
            "slice 3: StreamServe)"
        )

    # -- the recompile-with-directives loop ------------------------------------
    def repartition(
        self,
        xcf: Optional[Union[XCF, str, Path]] = None,
        *,
        backend: Optional[str] = None,
        threads: Optional[int] = None,
    ) -> "Program":
        """Same network, new placement — the paper's "change the directives
        and recompile" as one call.  Pass an XCF (object or path) or a
        synthesized corner via ``backend=``."""
        if (xcf is None) == (backend is None):
            raise FrontendError(
                "repartition() takes exactly one of xcf= or backend="
            )
        new = (
            synthesize_xcf(self._graph, backend, threads=threads)
            if backend is not None
            else _load_xcf(xcf)
        )
        return Program(self._source, self._graph, new, **self._opts)

    def profile(self, **_kw):
        """MILP profiling arrives with the profiling port."""
        raise NotImplementedError(
            "repro_torch: Program.profile() is not ported yet (ROADMAP A6, "
            "slice 2: profiling)"
        )

    def explore(self, prof=None, **_kw):
        """Placement exploration needs the profiling port."""
        raise NotImplementedError(
            "repro_torch: Program.explore() is not ported yet (ROADMAP A6, "
            "slice 2: profiling)"
        )


def compile(  # noqa: A001 - deliberate façade name: repro_torch.compile(...)
    net: Union[Network, ActorGraph],
    xcf: Optional[Union[XCF, str, Path]] = None,
    *,
    backend: str = "auto",
    threads: Optional[int] = None,
    controller: str = "am",
    block: int = 1024,
    default_depth: int = DEFAULT_DEPTH,
    max_execs_per_invoke: int = 10_000,
    fuse: bool = True,
    opt_level: int = 1,
    check: object = True,
    megastep: object = "auto",
    device=None,
) -> Program:
    """Compile a dataflow network into an executable ``Program``.

    Placement comes from ``xcf`` when given (object or path — the partitioner's
    output slots straight in); otherwise from ``backend``: ``"auto"``/``"host"``
    (one software thread), ``"threads"`` (round-robin over ``threads`` threads,
    default one per actor), or ``"device"`` (device-eligible actors on the
    accelerator behind a PLink).

    ``fuse=False`` disables SDF region fusion in the device partition (the
    unfused per-actor baseline); ``opt_level=2`` additionally folds fused op
    chains algebraically (faster, no longer bit-identical to unfused).

    ``check`` is the streamcheck policy (see ``repro_torch.analysis`` and
    docs/analysis.md): True (default) rejects networks with error-severity
    findings — inconsistent SDF rates, sure deadlocks, undersized buffers —
    at compile time with an ``AnalysisError`` carrying stable ``SB###``
    codes; ``"warn"`` collects findings without rejecting
    (``Program.check()`` returns them); False skips analysis.

    ``megastep`` sets the device megastep target — repetition-vector
    iterations per device launch (see docs/runtime.md): ``"auto"`` (default)
    uses the built-in target, an int pins it, ``False``/``None``/``1``
    disables megasteps (one block per launch).  The effective per-partition
    k is clamped by FIFO depths and statefulness at device compile time.

    ``device`` is the torch device of the hw partitions: ``None`` means
    ``cuda:0``, and a placement with a hw partition on CUDA raises when CUDA
    is not available.  Pass ``device="cpu"`` to run them on the CPU.
    """
    graph = _as_graph(net)
    if xcf is not None:
        if backend != "auto":
            raise FrontendError(
                f"pass xcf= or backend={backend!r}, not both — the XCF already "
                f"fixes the placement"
            )
        resolved = _load_xcf(xcf)
    else:
        resolved = synthesize_xcf(
            graph, "host" if backend == "auto" else backend, threads=threads
        )
    return Program(
        net,
        graph,
        resolved,
        controller=controller,
        block=block,
        default_depth=default_depth,
        max_execs_per_invoke=max_execs_per_invoke,
        fuse=fuse,
        opt_level=opt_level,
        check=check,
        megastep=megastep,
        device=device,
    )
