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

4. flash    — the three flash-attention kernels (``src/repro_torch/csrc/
             flash_attention.cu``: forward, dQ, dK/dV) against their plain
             PyTorch versions on the card at the training path's shape
             (B=8, S=2048, H=9, KV=3, hd=64, bf16, causal), a float32 shape
             and an hd=128 shape; kernel and plain device times (CUDA-graph
             replay) beside the bound and beside
             ``scaled_dot_product_attention`` (forward, and forward+backward).
5. train   — the LM slice's main path: ``repro_torch.launch.train.
             run_training("smollm-135m", reduced=False, steps=10,
             global_batch=8, seq_len=2048, device="cuda")`` with the flash
             launch counts set to 0 just before and read just after; loss
             finite and falling; then a profiled window of three steps for the
             device's idle share, and one step with ``use_kernels="off"``
             from the same parameters and batch, whose loss must match.

The line before the last is the card's name and power limit, the one before
that a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``, printed only when every check passed.
Exits non-zero without a result when CUDA is not available or the package is
missing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS_PER_S = 67e12   # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
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


# ---------------------------------------------------------------------------
# Phase 4: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_SHAPES = {
    # name: (B, S, H, KV, hd, dtype)
    "path": (8, 2048, 9, 3, 64, torch.bfloat16),
    "f32": (2, 512, 4, 2, 64, torch.float32),
    "hd128": (2, 1024, 32, 8, 128, torch.bfloat16),
}
FLASH_TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (3e-5, 2e-4)}  # (fwd, bwd)
FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def reps_for(fn, budget_s: float = 0.2, most: int = 50) -> int:
    """How many calls fill about ``budget_s`` of device time (at least 3)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(most, int(budget_s / max(time.perf_counter() - t0, 1e-6))))


def flash_bounds(B, S, H, KV, hd, dtype) -> dict:
    """Least time (ms) for each kernel's work: matrix FLOPs over the peak for
    the type, or bytes (each input read once, each output written once) over
    HBM bandwidth, whichever is larger."""
    pairs = B * H * S * (S + 1) // 2  # causal (query, key) pairs
    esz = torch.finfo(dtype).bits // 8
    q_b, kv_b, row_b = B * H * S * hd * esz, B * KV * S * hd * esz, B * H * S * 4
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    work = {
        # QK^T and PV
        "flash_fwd": (4 * pairs * hd, 2 * q_b + 2 * kv_b + row_b),
        # QK^T, dO.V^T, dS.K
        "flash_bwd_dq": (6 * pairs * hd, 3 * q_b + 2 * kv_b + 2 * row_b),
        # QK^T, dO.V^T, P^T.dO, dS^T.Q
        "flash_bwd_dkv": (8 * pairs * hd, 2 * q_b + 4 * kv_b + 2 * row_b),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        b_ops, b_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = dict(
            flops=flops, bytes=nbytes, bound_ms=max(b_ops, b_bytes),
            bound_by="operations" if b_ops >= b_bytes else "bytes",
        )
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return bool(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol))


def phase_flash() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.ops import flash_attention

    print("phase 4: flash kernels against their plain versions on the card", flush=True)
    rows = {}
    for shape, (B, S, H, KV, hd, dtype) in FLASH_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(len(rows))

        def randn(*size):
            return torch.randn(*size, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

        q, do = randn(B * H, S, hd), randn(B * H, S, hd)
        k, v = randn(B * KV, S, hd), randn(B * KV, S, hd)
        tol_f, tol_b = FLASH_TOL[dtype]

        o_k, lse_k = kernel.flash_fwd_cuda(q, k, v, causal=True)
        o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=True)
        delta = ref.delta_of(o_p, do)
        dq_k = kernel.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, causal=True)
        dq_p = ref.flash_bwd_dq_ref(q, k, v, do, lse_p, delta, causal=True)
        dk_k, dv_k = kernel.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, causal=True)
        dk_p, dv_p = ref.flash_bwd_dkv_ref(q, k, v, do, lse_p, delta, causal=True)
        torch.cuda.synchronize()
        errs = {
            "flash_fwd": max(max_err(o_k, o_p), max_err(lse_k, lse_p)),
            "flash_bwd_dq": max_err(dq_k, dq_p),
            "flash_bwd_dkv": max(max_err(dk_k, dk_p), max_err(dv_k, dv_p)),
        }
        for what, a, b, tol in (
            ("o", o_k, o_p, tol_f), ("lse", lse_k, lse_p, tol_f), ("dq", dq_k, dq_p, tol_b),
            ("dk", dk_k, dk_p, tol_b), ("dv", dv_k, dv_p, tol_b),
        ):
            check(close(a, b, tol), f"flash {shape}: kernel {what} not within {tol} of plain "
                                    f"(max abs err {max_err(a, b):.3g})")
        for t in (o_k, lse_k, dq_k, dk_k, dv_k):
            check(bool(torch.isfinite(t).all()), f"flash {shape}: non-finite kernel output")

        calls = {
            "flash_fwd": (lambda: kernel.flash_fwd_cuda(q, k, v, causal=True),
                          lambda: ref.flash_fwd_ref(q, k, v, causal=True)),
            "flash_bwd_dq": (
                lambda: kernel.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, causal=True),
                lambda: ref.flash_bwd_dq_ref(q, k, v, do, lse_p, delta, causal=True)),
            "flash_bwd_dkv": (
                lambda: kernel.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, causal=True),
                lambda: ref.flash_bwd_dkv_ref(q, k, v, do, lse_p, delta, causal=True)),
        }
        bounds = flash_bounds(B, S, H, KV, hd, dtype)
        times = {}
        for name, (kern, plain) in calls.items():
            times[name] = (device_ms(kern, reps_for(kern)), device_ms(plain, reps_for(plain)))

        # the library yardstick, never called by the port
        q4, k4, v4 = q.view(B, H, S, hd), k.view(B, KV, S, hd), v.view(B, KV, S, hd)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)

        sdpa_ms = device_ms(sdpa, reps_for(sdpa))
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        do4 = do.view(B, H, S, hd)

        def sdpa_fb():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        qs = q.view(B, H, S, hd).transpose(1, 2).detach().requires_grad_(True)
        ks = k.view(B, KV, S, hd).transpose(1, 2).detach().requires_grad_(True)
        vs = v.view(B, KV, S, hd).transpose(1, 2).detach().requires_grad_(True)
        dos = do4.transpose(1, 2)

        def ours_fb():
            out = flash_attention(qs, ks, vs, causal=True)
            torch.autograd.grad(out, (qs, ks, vs), dos)

        sdpa_fb_ms = call_ms(sdpa_fb, reps_for(sdpa_fb))
        ours_fb_ms = call_ms(ours_fb, reps_for(ours_fb))
        for name in FLASH_NAMES:
            row = dict(
                shape=shape, kernel=name, B=B, S=S, H=H, KV=KV, hd=hd, dtype=str(dtype),
                max_abs_err=errs[name], ms=times[name][0], plain_ms=times[name][1],
                **bounds[name],
                library_ms=sdpa_ms if name == "flash_fwd" else None,
            )
            rows[(shape, name)] = row
            print("  " + json.dumps(row), flush=True)
        print("  " + json.dumps(dict(
            shape=shape, sdpa_fwd_ms=sdpa_ms, sdpa_fwd_bwd_call_ms=sdpa_fb_ms,
            port_fwd_bwd_call_ms=ours_fb_ms,
        )), flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 5: LM training, the slice's main path
# ---------------------------------------------------------------------------

TRAIN = dict(arch="smollm-135m", steps=10, global_batch=8, seq_len=2048)


def flash_counts() -> dict:
    from repro_torch.kernels.flash_attention import kernel

    return {"flash_fwd": kernel.FWD_LAUNCHES, "flash_bwd_dq": kernel.DQ_LAUNCHES,
            "flash_bwd_dkv": kernel.DKV_LAUNCHES}


def profiled_idle_share(train_step, params, opt_state, batch, n: int = 3) -> dict:
    """Device busy and idle share over ``n`` steps, from torch.profiler's CUDA
    activity alone, so each kernel's time is counted once (one warm-up step
    first)."""
    train_step(params, opt_state, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            train_step(params, opt_state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    busy_us, flash_us, by_kernel = 0.0, {}, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0.0) if us is None else us
        busy_us += us
        by_kernel.append((us, ev.count, ev.key))
        for name in FLASH_NAMES:
            if f"{name}_" in ev.key:  # flash_fwd_mma_kernel<64>, ...
                flash_us[name] = flash_us.get(name, 0.0) + us
    top = [dict(ms_per_step=us / 1e3 / n, calls_per_step=c / n, kernel=key[:90])
           for us, c, key in sorted(by_kernel, reverse=True)[:12]]
    return dict(
        steps=n, seconds=secs, device_busy_ms=busy_us / 1e3,
        idle_share=1.0 - busy_us / 1e6 / secs,
        flash_ms={k: v / 1e3 for k, v in flash_us.items()}, top_kernels=top,
    )


def phase_train() -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import run_training
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, init_opt_state

    print("phase 5: LM training, the main path", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        kernel.FWD_LAUNCHES = kernel.DQ_LAUNCHES = kernel.DKV_LAUNCHES = 0
        out = run_training(
            TRAIN["arch"], reduced=False, steps=TRAIN["steps"],
            global_batch=TRAIN["global_batch"], seq_len=TRAIN["seq_len"],
            ckpt_dir=ckpt, log_every=1, device="cuda",
        )
        torch.cuda.synchronize()
        launches = flash_counts()
    losses = out["losses"]
    steady = sorted(out["step_seconds"][1:])
    step_s = steady[len(steady) // 2]
    row = dict(
        steps=out["steps"], losses=losses, step_seconds=out["step_seconds"],
        median_step_s=step_s, tokens_per_s=out["tokens_per_step"] / step_s,
        launches=launches,
        launches_per_step={k: v / max(out["steps"], 1) for k, v in launches.items()},
    )
    print("  " + json.dumps(row), flush=True)
    check(out["steps"] == TRAIN["steps"], f"train: {out['steps']} steps done")
    check(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    check(len(losses) >= 6 and np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"train: loss did not fall ({losses})")
    for name, n in launches.items():
        check(n > 0, f"train: {name} was never launched on the main path")

    # one batch and one set of parameters for the profiled window and the
    # kernel-vs-plain step
    cfg = get_config(TRAIN["arch"])
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN["steps"])
    params = lm.init_model(cfg, 0, device="cuda")
    opt_state = init_opt_state(params, opt)
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
        global_batch=TRAIN["global_batch"], seed=0,
    )).next_batch()
    step_k = make_train_step(cfg, opt)
    prof = profiled_idle_share(step_k, params, opt_state, batch)
    print("  " + json.dumps({"profiled": prof}), flush=True)
    row["profiled"] = prof

    _, _, m_k = step_k(params, opt_state, batch)
    step_o = make_train_step(dataclasses.replace(cfg, use_kernels="off"), opt)
    _, _, m_o = step_o(params, opt_state, batch)
    loss_k, loss_o = float(m_k["loss"]), float(m_o["loss"])
    gn_k, gn_o = float(m_k["grad_norm"]), float(m_o["grad_norm"])
    print(f"  one step, same params and batch: loss cuda {loss_k:.6f} off {loss_o:.6f} "
          f"(|diff| {abs(loss_k - loss_o):.3g}); grad norm cuda {gn_k:.6f} off {gn_o:.6f}",
          flush=True)
    check(abs(loss_k - loss_o) <= 2e-2, "train: kernel path's loss not within 2e-2 of plain")
    row.update(loss_cuda=loss_k, loss_off=loss_o, grad_norm_cuda=gn_k, grad_norm_off=gn_o)
    return row


def build_all():
    """Build every kernel library at once: one nvcc per source, in parallel."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.stream_fused import kernel as stream

    errors = []

    def run(mod):
        try:
            mod.build()
        except Exception as e:  # noqa: BLE001 — reported below, fails the run
            errors.append(f"{mod.__name__}: {e}")

    threads = [threading.Thread(target=run, args=(m,)) for m in (stream, flash)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for mod in (stream, flash):
        print(f"  {mod.SOURCE.name}: nvcc build {mod.BUILD_SECONDS}s", flush=True)
        for line in mod.BUILD_LOG.strip().splitlines():
            print(f"    {line.strip()}", flush=True)
    if errors:
        raise RuntimeError("kernel build failed: " + "; ".join(errors))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.apps.streams import NETWORKS

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in IEEE float32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"phase 1: build; card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    build_all()

    programs = {"demo": demo_program(), **network_programs(NETWORKS)}
    rows = phase_kernel(programs)
    launches = phase_e2e(NETWORKS)
    flash_rows = phase_flash()
    train = phase_train()

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
    replaces = {
        "flash_fwd": "src/repro/kernels/flash_attention/kernel.py:79",
        "flash_bwd_dq": "src/repro/kernels/flash_attention/kernel.py:235",
        "flash_bwd_dkv": "src/repro/kernels/flash_attention/kernel.py:255",
    }
    for name in FLASH_NAMES:
        row = flash_rows[("path", name)]
        record["kernels"].append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces=replaces[name], launches=train["launches"][name],
            max_abs_err=max(flash_rows[(s, name)]["max_abs_err"] for s in FLASH_SHAPES),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
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
