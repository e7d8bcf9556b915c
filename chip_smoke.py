"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line or more each:

1. build   — compile the stream kernel (``src/repro_torch/csrc/``) with nvcc
             for sm_90a; print the build time, the ptxas report and the
             card's name and power limit.
2. kernel  — the CUDA kernel against its plain PyTorch version on the card,
             bitwise, for the demo program and the four fused Table-I
             programs at N = 4*4096 (one megastep launch at block 4096) and
             N = 32*4*4096 (one serve round of 32 lanes), inputs seeded with
             NaN, +-0 and +-inf; kernel and plain times from CUDA events
             beside the least time the card could take.
3. e2e     — the main path: ``repro_torch.compile(net, backend="device",
             block=4096).run()`` on the five Table-I networks at the
             benchmark sizes, with the kernel's launch count set to 0 just
             before and read just after; then the checks against the host
             backend and the port's bitwise invariants (fused == unfused,
             megastep == per-iteration, 2 partitions == 1), and a second,
             instrumented run per network for the boundary breakdown.

The line before the last is the card's name and power limit, the one before
that a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``, printed only when every check passed.
Exits non-zero without a result when CUDA is not available or the package is
missing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12   # H100 SXM, float32 outside the tensor cores
TOKENS = {"main": 4 * 4096, "serve": 32 * 4 * 4096}
SIZES = {"TopFilter": 40000, "FIR32": 8000, "Bitonic8": 1500, "IDCT8": 1500, "ZigZag": 200}
EXACT = {"TopFilter", "Bitonic8", "ZigZag"}
FUSED_NETS = ("FIR32", "Bitonic8", "IDCT8", "ZigZag")
BLOCK = 4096

failures: list = []


def check(ok: bool, what: str) -> bool:
    if not ok:
        failures.append(what)
        print(f"  FAIL {what}", flush=True)
    return ok


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def network_programs(nets):
    """The four fused Table-I programs, as the port's lowering makes them."""
    import repro_torch

    progs = {}
    for name in FUSED_NETS:
        net, _ = nets[name](n=64) if name == "FIR32" else nets[name](8)
        p = repro_torch.compile(net, backend="device", block=BLOCK, device="cpu")
        (fused,) = [a for a in p.module.actors.values() if a.is_fused]
        progs[name] = fused.impl.stream_program
    return progs


def demo_program():
    from repro_torch.kernels.stream_fused import StreamOp, StreamProgram

    basis = np.linalg.qr(np.random.default_rng(0).normal(size=(8, 8)))[0]
    ops = (
        StreamOp("affine", (0,), 2, (-1.5, 0.25, 3.0)),
        StreamOp("matmul8", (2,), 3, (basis.astype(np.float32),)),
        StreamOp("const", (1,), 4, (0.0,)),
        StreamOp("axpy", (3, 4), 5, (0.7,)),
        StreamOp("min2", (5, 1), 6),
        StreamOp("max2", (5, 1), 7),
        StreamOp("clip", (7,), 8, (-2.0, 2.0)),
    )
    return StreamProgram(n_inputs=2, n_regs=9, ops=ops, outputs=(6, 8))


def flops_per_token(program) -> int:
    n = 0
    for op in program.ops:
        if op.kind == "affine":
            pre, mul, post = op.params
            n += (pre != 0.0) + (mul != 1.0) + (post != 0.0)
        elif op.kind == "matmul8":
            n += 15
        elif op.kind in ("axpy", "clip"):
            n += 2
        elif op.kind in ("min2", "max2"):
            n += 1
    return n


def seeded_inputs(program, n: int, seed: int):
    rng = np.random.default_rng(seed)
    xs = []
    for _ in range(program.n_inputs):
        x = (rng.normal(size=n) * 100).astype(np.float32)
        pos = rng.choice(n, size=10, replace=False)
        x[pos] = [np.nan, np.nan, 0.0, 0.0, -0.0, -0.0, np.inf, -np.inf, np.inf, -np.inf]
        xs.append(torch.from_numpy(x).cuda())
    return xs


def compare(a: torch.Tensor, b: torch.Tensor):
    """(bitwise equal at every non-NaN position and NaN at the same ones,
    max |a - b| where both are finite)."""
    an, bn = torch.isnan(a), torch.isnan(b)
    same = bool(torch.equal(an, bn)) and bool(
        torch.equal(a.view(torch.int32)[~an], b.view(torch.int32)[~an])
    )
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return same, err


def _events(run, reps: int) -> float:
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def call_ms(fn, reps: int) -> float:
    """ms per call, back to back from Python: what a caller pays per launch
    (host-bound when the device work is shorter than the call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    return _events(run, reps)


def device_ms(fn, reps: int) -> float:
    """ms per call on the device alone: ``reps`` calls captured in one CUDA
    graph, replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events(graph.replay, reps)


def phase_kernel(programs) -> dict:
    from repro_torch.kernels.stream_fused import kernel
    from repro_torch.kernels.stream_fused.ref import fused_stream_ref

    print("phase 2: kernel against its plain version on the card", flush=True)
    rows = {}
    for seed, (name, prog) in enumerate(programs.items()):
        for size, n in TOKENS.items():
            xs = seeded_inputs(prog, n, seed)
            got = kernel.fused_stream_cuda(xs, prog)
            want = fused_stream_ref(xs, prog)
            torch.cuda.synchronize()
            same, err = True, 0.0
            for g, w in zip(got, want):
                s, e = compare(g, w)
                same, err = same and s, max(err, e)
            check(same, f"kernel != plain version bitwise: {name} N={n}")
            reps = 200 if n <= TOKENS["main"] else 40

            def launch():
                return kernel.fused_stream_cuda(xs, prog)

            def plain():
                return fused_stream_ref(xs, prog)

            ms, plain_ms = device_ms(launch, reps), device_ms(plain, reps)
            k_call, p_call = call_ms(launch, reps), call_ms(plain, reps)
            nbytes = 4 * n * (prog.n_inputs + len(prog.outputs))
            flops = flops_per_token(prog) * n
            b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
            row = dict(
                program=name, N=n, bitwise=same, max_abs_err=err, kernel_ms=ms,
                plain_ms=plain_ms, call_ms=k_call, plain_call_ms=p_call,
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                bytes=nbytes, flops=flops, n_slots=kernel.lower(prog).n_slots,
            )
            rows[(name, size)] = row
            print("  " + json.dumps(row), flush=True)
    # +-0 ties through min2/max2: what the card does, held bitwise
    from repro_torch.kernels.stream_fused import StreamOp, StreamProgram

    ties = StreamProgram(2, 4, (StreamOp("min2", (0, 1), 2), StreamOp("max2", (0, 1), 3)), (2, 3))
    a = torch.tensor([0.0, -0.0] * 4, device="cuda")
    b = torch.tensor([-0.0, 0.0] * 4, device="cuda")
    kmin, kmax = kernel.fused_stream_cuda([a, b], ties)
    pmin, pmax = fused_stream_ref([a, b], ties)
    cmin, cmax = fused_stream_ref([a.cpu(), b.cpu()], ties)
    torch.cuda.synchronize()

    def signs(t):
        return "".join("-" if torch.signbit(v) else "+" for v in t[:2].cpu())

    for k, p in ((kmin, pmin), (kmax, pmax)):
        check(compare(k, p)[0], "kernel != plain version on +-0 ties")
    print(
        "  zero ties (a=[+0,-0], b=[-0,+0]): "
        f"min kernel {signs(kmin)} plain-cuda {signs(pmin)} plain-cpu {signs(cmin)}; "
        f"max kernel {signs(kmax)} plain-cuda {signs(pmax)} plain-cpu {signs(cmax)}",
        flush=True,
    )
    return rows


def run_net(nets, name, **kw):
    import repro_torch

    net, got = nets[name](n=SIZES[name]) if name == "FIR32" else nets[name](SIZES[name])
    prog = repro_torch.compile(net, **kw)
    report = prog.run()
    return list(got), report, prog


def phase_e2e(nets) -> dict:
    import repro_torch
    from repro_torch.core.xcf import make_xcf
    from repro_torch.kernels.stream_fused import kernel

    print("phase 3: end to end, the main path", flush=True)
    kernel.LAUNCHES = 0  # the count covers the main path's runs only
    main, launches = {}, {}
    for name in SIZES:
        before = kernel.LAUNCHES
        out, rep, prog = run_net(nets, name, backend="device", block=BLOCK)
        torch.cuda.synchronize()
        launches[name] = kernel.LAUNCHES - before
        main[name] = (out, rep, prog)
    print(f"  kernel launches on the main path: {launches}", flush=True)

    for name, (out, rep, prog) in main.items():
        devs = {str(p.device) for p in prog.device_programs().values()}
        check(all(d.startswith("cuda") for d in devs), f"{name}: device programs on {devs}")
        check(rep.plink_launches >= 1, f"{name}: plink_launches={rep.plink_launches}")
        if name in FUSED_NETS:
            check(launches[name] > 0, f"{name}: the stream kernel was never launched")
        host, _, _ = run_net(nets, name, backend="host")
        check(len(out) == len(host) > 0, f"{name}: {len(out)} outputs vs {len(host)} on host")
        if name in EXACT:
            check(out == host, f"{name}: device != host bitwise")
        else:
            check(
                np.allclose(out, host, rtol=1e-5, atol=1e-4),
                f"{name}: device not allclose to host",
            )
        unfused, _, _ = run_net(nets, name, backend="device", block=BLOCK, fuse=False)
        check(unfused == out, f"{name}: fused != unfused bitwise")
        per_iter, _, _ = run_net(nets, name, backend="device", block=BLOCK, megastep=False)
        check(per_iter == out, f"{name}: megastep != per-iteration bitwise")

        # instrumented second run: the boundary breakdown of one run, and
        # the device's busy time from the CUDA profiler
        rt = prog._build_runtime()
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            rt.run_threads()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        busy_us = kern_us = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            us = getattr(ev, "self_cuda_time_total", 0.0) if us is None else us
            busy_us += us
            if ev.key.startswith("stream_fused_kernel"):
                kern_us += us
        ps = [pl.stats for pl in rt.plinks.values()]
        lanes = {pl.name for pl in rt.plinks.values()}
        host_ns = sum(p.time_ns for a, p in rt.profiles.items() if a not in lanes)
        row = dict(
            seconds=rep.seconds, tokens_out=len(out),
            tokens_per_s=len(out) / rep.seconds, plink_launches=rep.plink_launches,
            kernel_launches=launches[name], megastep_k=prog.device_program().megastep_k,
            instrumented_seconds=secs,
            stage_ms=sum(p.stage_ns for p in ps) / 1e6,
            dispatch_ms=sum(p.dispatch_ns for p in ps) / 1e6,
            sync_ms=sum(p.sync_ns for p in ps) / 1e6,
            retire_ms=sum(p.retire_ns for p in ps) / 1e6,
            host_actor_ms=host_ns / 1e6,
            profiled_device_busy_ms=busy_us / 1e3,
            profiled_stream_kernel_ms=kern_us / 1e3,
            profiled_idle_share=1.0 - busy_us / 1e6 / secs,
        )
        print("  " + json.dumps({"network": name, **row}), flush=True)

    net, got = nets["IDCT8"](SIZES["IDCT8"])
    two = make_xcf(
        "IDCT8",
        {"source": "t0", "descale": "dA", "idct": "dB", "clip": "dB", "sink": "t0"},
        accel=("dA", "dB"),
    )
    p2 = repro_torch.compile(net, two, block=BLOCK)
    rep2 = p2.run()
    check(p2.hw_partitions == ["dA", "dB"], "IDCT8: 2-partition placement")
    check(list(got) == main["IDCT8"][0], "IDCT8: 2 partitions != 1 partition bitwise")
    print(f"  IDCT8 2-partition: {rep2}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.apps.streams import NETWORKS
    from repro_torch.kernels.stream_fused import kernel

    card = gpu_line()
    print(f"phase 1: build; card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    kernel.build()
    print(f"  nvcc build {kernel.BUILD_SECONDS:.2f}s", flush=True)
    for line in kernel.BUILD_LOG.strip().splitlines():
        print(f"  {line.strip()}", flush=True)

    programs = {"demo": demo_program(), **network_programs(NETWORKS)}
    rows = phase_kernel(programs)
    launches = phase_e2e(NETWORKS)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", flush=True)
        return 1
    record = {"kernels": []}
    for name in FUSED_NETS:
        row = rows[(name, "main")]
        record["kernels"].append(dict(
            name=f"fused_stream[{name}]", route="cuda",
            source="src/repro_torch/csrc/stream_fused.cu",
            replaces="src/repro/kernels/stream_fused/kernel.py:74",
            launches=launches[name], max_abs_err=max(
                rows[(name, s)]["max_abs_err"] for s in TOKENS
            ),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
        ))
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
