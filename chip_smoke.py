"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line or more each:

1. build   — compile the five CUDA sources (``src/repro_torch/csrc/*.cu``)
             and the stream kernel generated for each program phase 2 runs
             (the demo, the four fused Table-I programs, a P = 24 perm and
             the +-0 ties;
             ``kernels/stream_fused/kernel.py`` writes them under
             ``src/repro_torch/build/`` from the template
             ``csrc/stream_fused.cuh``), one nvcc each for sm_90a, all in
             parallel; print the build times, the ptxas reports (a spill in
             a generated stream kernel fails the run) and the card's name
             and power limit.
2. kernel  — each generated stream kernel against its plain PyTorch
             version on the card, bitwise, for the demo program, the four
             fused Table-I programs and a perm of P = 24 (staged over the
             block) at N = 4*4096 (one megastep launch at block 4096), N =
             32*4*4096 (one serve round of 32 lanes) and N = 256*4*4096 (each
             rounded down to the program's block unit), inputs seeded with
             NaN, +-0 and +-inf, on wires off a 16-byte boundary (scalar
             loads), on lane-major (128, block) stacks as a batched serve
             round hands them (32 lanes of 4 chunks at phase 13's block), and
             on +-0 ties through min2 / max2; kernel and plain device times
             (CUDA-graph replay) beside the least time the card could take
             and an empty kernel's time on the same grid (the launch floor).
3. e2e     — the main path: ``repro_torch.compile(net, backend="device",
             block=4096).run()`` on the five Table-I networks at the
             benchmark sizes, with the kernel's launch count set to 0 just
             before and read just after (exactly one launch of each fused
             region per PLink launch, its megastep being flat: TopFilter,
             which has none, 0; how often PLink launches follows the host's
             timing) and no kernel build or load inside
             ``RunReport.seconds``; then the checks against the host
             backend and the port's bitwise invariants (fused == unfused,
             megastep == per-iteration, 2 partitions == 1), and a second,
             instrumented run per network for the boundary breakdown.

4. flash    — the bf16 kernels' ptxas reports (a spill or serialised wgmmas
             in a backward kernel at hd 64 fails the run),
             then the three flash-attention kernels (``src/repro_torch/csrc/
             flash_attention.cu``: forward, dQ, dK/dV) against their plain
             PyTorch versions on the card at the training path's shape
             (B=8, S=2048, H=9, KV=3, hd=64, bf16, causal), an hd=128 shape,
             hd=16 and hd=32 shapes at S=192 (S % 128 == 64), a non-causal
             bf16 shape and a float32 shape; kernel and plain device times
             (CUDA-graph replay) beside the bound and beside
             ``scaled_dot_product_attention``: its forward for the forward,
             its backward alone (one ``autograd.grad`` on a retained graph,
             dQ, dK and dV together, queued behind a spin kernel so the
             events time the device) for dQ and dK/dV, and forward+backward.
5. train   — the LM slice's main path: ``repro_torch.launch.train.
             run_training("smollm-135m", reduced=False, steps=10,
             global_batch=8, seq_len=2048, device="cuda")`` with the flash
             launch counts set to 0 just before and read just after; loss
             finite and falling; then a profiled window of three steps after
             a discarded warm-up step (``profile_window``: the device's idle
             share, the flash kernels' ms per step, each and together, the
             device records beside what the host enqueued; no float32 GEMM
             launched 8 times a step among the top kernels: the LM head's
             forward is a bf16 product with a float32 result), and one step
             with ``use_kernels="off"``
             from the same parameters and batch, whose loss must match.  The
             RMSNorm kernel runs on this path too (every block norm and the
             final norm, again in each block's recompute).
6. norm+ssd — the RMSNorm kernel (``src/repro_torch/csrc/rmsnorm.cu``) and
             the SSD scan kernels (``src/repro_torch/csrc/ssd_scan.cu``):
             their ptxas reports (a spill or serialised wgmmas in an RMSNorm
             instantiation this phase runs or in a bf16 SSD kernel of the
             TMA path fail the run), then each against its plain
             PyTorch version on the card: RMSNorm at R = 16384 and R = 8
             rows of d = 768, 1536 (mamba2-130m), 576 (smollm-135m) and 2048
             (deepseek-moe-16b), bfloat16 and float32, d = 771 (the scalar
             instantiation) at R = 16384 and 8, and R = 8 rows wider than
             eight warps' registers (bf16 d = 40000, f32 d = 100000: a row in
             passes); SSD at the serving path's shape (B=8, S=2048, nh=24,
             P=64, N=128, chunk 256, bfloat16), two ragged bf16 shapes (P, N
             zero-padded through TMA; P, N and the chunk off every tile
             width, staged by threads), a float32 shape and a small one,
             and a bf16 shape with da > 0 on every second head (there the
             kernels take W and the entering state as bf16 pairs; y and the
             state held to SSD_TOL); kernel and plain device times (CUDA-graph replay)
             beside the bound (SSD: at the tensor cores' rate and at
             float32's), ``F.rms_norm`` beside RMSNorm (no PyTorch call
             computes the SSD scan), and at the SSD path each of the call's
             three kernels' device time from the profiler, which must see
             each of them once a call.  Then the SSD backward kernels
             (``ssd_bwd_*``, every one strict on its ptxas report) against
             ``ref.ssd_scan_bwd_ref`` in float32 on the same bf16 inputs,
             with the final state's cotangent and without, at the path, the
             mamba2-130m training cell's shape (B=24), da > 0 and the two
             ragged shapes, within SSD_BWD_TOL, two calls bit for bit; at
             the path its time, each kernel's, the plain vjp's and the bound
             (the count of ``bench/metrics/ssd_bwd_roofline.train.py``).
             The forward's and the backward's entries each refuse the
             other's layout of x in their own check.
7. serve   — LM serving, this slice's main path:
             ``repro_torch.launch.serve.run_serving("mamba2-130m",
             reduced=False, batch=8, prompt_len=2048, max_new=64,
             device="cuda")`` with the kernels' launch counts set to 0 just
             before and read just after (24 ``ssd_scan`` per prefill, 49
             ``rmsnorm`` per forward and per decode step); prefill and decode
             tokens/s and the device idle share of a profiled decode window
             (16 steps after a discarded warm-up step); the device time of
             three profiled prefills, with the SSD scan's and RMSNorm's
             share of it;
             prefill + decode against the full forward (B=2, S0=512, S=768);
             the kernel path against ``use_kernels="off"`` on one prompt of
             the path's length (B=1, S=2048), every bf16 check beside a
             lost-state control that must exceed its limit; a
             ``ServingEngine`` (4 slots, 8 requests of 128-768 tokens) against
             each request's isolated generation; and ``run_serving`` on
             smollm-135m at its published widths (one ``flash_fwd`` a layer
             for its prefill, none for decode), then its prefill's attention
             through the flash forward against ``use_kernels="off"``: one
             layer at S = 2048 and a padded 2000 (bf16 tolerance, the cache
             bitwise), and whole 2 x 2048 prefills (30 forwards each, last
             logits within the bf16 limit).
8. gmm     — the grouped-matmul kernel (``src/repro_torch/csrc/moe_gmm.cu``):
             its ptxas report (a spill or serialised wgmmas fail the run),
             then against its plain PyTorch version on the card at the MoE
             path's shapes: bf16
             gate/up (64, 1984, 2048) x (64, 2048, 1408), down (64, 1984,
             1408) x (64, 1408, 2048), decode at C = 8 and C = 6, and a
             float32 shape; each row bitwise the same whatever C and the tile
             plan (C = 1, 6, 8, 40, 64, 65, 128, 248, 1984, and a row moved
             to the top of its tile); kernel, plain and ``torch.bmm`` device
             times (CUDA-graph replay) beside the bound.
9. moe     — MoE serving, this slice's main path:
             ``run_serving("deepseek-moe-16b", reduced=False, batch=8,
             prompt_len=2048, max_new=64, device="cuda")`` with the launch
             counts set to 0 just before and read just after (84 ``moe_gmm``
             and 57 ``rmsnorm`` per forward and per decode step, 28
             ``flash_fwd`` for the prefill); prefill and
             decode tokens/s, peak memory, the init seconds and the idle
             share of a profiled decode window with ``moe_gmm``'s ms in it
             (as phase 7's; the attention
             products read the bf16 K/V cache as it lies, with float32
             results, so no copy or elementwise kernel in it may last as
             long as reading one layer's K cache); those two products alone
             against their plain version at the window's cache and over a
             sweep of head counts and cache lengths, timed beside one strided
             bmm per kv head and beside reading K and V once; prefill +
             decode against the forward (B=2, S0=512, S=768) on a capacity
             nothing overflows;
             the kernel path against ``use_kernels="off"`` on one 2048-token
             prompt; each bf16 check on the median position, beside a control
             that must exceed its limit; float32 (4 of 28 layers) at the
             reference's tolerances; and the 4-slot engine against isolated
             generation (held in float32, printed in bf16).
10. quant   — the int8 quantization kernel (``src/repro_torch/csrc/quant.cu``)
             against its plain PyTorch version on the card, bitwise in the
             codes and the scales, at the compression path's rows for
             smollm-135m's 11 gradient leaves, at llama3-8b leaves (the
             (4096, 128256) head, the (131072, 14336) bf16 stacked w_gate,
             (131072, 4096)) and on one row of 2**20, with rows of NaN,
             +-inf, zeros, -0.0 and half-way ties; kernel and plain device
             times beside the byte bound (no PyTorch call computes it).
11. compress — int8 error-feedback compression, this slice's main path: the
             gradient tree of one ``lm_loss`` backward of smollm-135m at its
             published widths (B=8, S=2048, ``use_kernels="cuda"``), then
             ``init_ef_state`` and 20 rounds of ``ef_compress_grads`` with
             the quant launch count set to 0 just before and read just after
             (11 per round); every round bitwise against
             ``use_kernels="off"``; the error-feedback bound of the
             reference's test (relative error of the summed compressed
             grads under 0.01); ms per round, the kernel's share and the
             idle share of a profiled window; and ``all_reduce_int8`` over
             a one-rank NCCL group against the round trip, bitwise.
12. explore — first the unfused device step (ROADMAP C8): up to three
             single-actor partitions a network as ``profile_device`` builds
             them, each step's kernels, device µs and host µs a call eager
             beside its CUDA-graph replay (``core/profiler.py::capture_step``,
             what ``profile_device`` now times), the replay bitwise the eager step
             (and the CPU's on the compare-only networks); then
             the profile-guided partitioner on the five Table-I networks at
             ``benchmarks/table2_dse.py``'s sizes (block 2048, links over 256,
             1024 and 4096 tokens): ``profile()`` on the card, then
             ``explore(thread_counts=(1, 2, 3), accel_options=(False, True))``;
             every design point's predicted seconds and hw actors; the best
             point, the best point that uses the device and the all-device
             corner (priced by the same cost model) run through
             ``repartition(xcf).run()``, predicted against measured seconds,
             outputs against the host backend (bitwise on TopFilter, Bitonic8
             and ZigZag), each run launching the stream kernel exactly when
             its placement has a fused region and the corner of every fused
             network launching it, and no kernel build inside a run.  Points
             whose device part feeds itself through the host (PLink's
             lockstep staging would stall there) are printed, and compiling
             each must raise; where that leaves no point on the device, the
             corner runs alone.  IDCT8 over 0-2 accelerator partitions of at most 2
             actors, on the live profile and on a pinned one: the
             2-partition placement against 1 partition, bitwise.
             ``measure_device_link()``'s latency and bandwidth.
13. serve   — StreamServe on FIR32 at block 1024
             (``benchmarks/server_throughput.py``): 1-32 sessions splitting
             262144 tokens, served continuously (``max_batch=32``) and one
             launch per session; every session bitwise its isolated
             ``run()``; the stream kernel's launches exactly one per round
             (the partition's one fused program) whatever the lanes; tokens/s,
             TTFO and inter-block p50/p99; no server meets a fault or
             degrades to the host, and each runs rounds on the card; a
             mixed partition (Bitonic8's fused {ce0, ce4} beside an unfused
             ce2) served to 4 sessions, one launch a round, bitwise; the
             device's idle share over a
             profiled stretch; 1000 sessions of 256 tokens plus a hog of
             64x256 split at admission (small sessions' p95 TTFO); a kill
             mid-stream with periodic checkpoints and ``StreamServer.recover``,
             bitwise; and one ``OnlineRepartitioner`` move of TopFilter from
             the host onto the card mid-stream, bitwise.
14. train   — SSM and MoE training through the kernels: mamba2-130m at its
             published widths and depth (8 x 2048 tokens, ``remat="block"``)
             and deepseek-moe-16b at its published widths and 4 of its 28
             layers (4 x 2048, ``remat="save_dispatch"``; the cut is forced
             by memory: parameters, gradients and two float32 moments, old
             and new in the update), ``use_kernels="cuda"``.  First one
             ``lm_loss`` forward and backward on the seeded parameters and
             batch: the kernels launched in the forward and in the backward
             (``ssd_scan`` 24 + 24 in the blocks' recompute and 24
             ``ssd_scan_bwd``, one a layer; ``moe_gmm``
             forwards, their recompute and dx launches apart; flash and
             RMSNorm), the loss within 2e-2 of ``use_kernels="off"`` and the
             gradient norm within 2e-2 relative, and for deepseek the loss
             under ``remat="block"`` equal to ``save_dispatch``'s, the peak
             memory of each recorded.  Then 10 steps of the train step
             (AdamW) with the counts set to 0 just before and read just
             after: losses finite and falling, tokens/s, peak memory; a
             profiled window of three steps (idle share, top kernels); and
             the new backwards' pieces a layer at the path's shapes (the SSD
             backward, the transposed weight copy, dx and dW).
15. sharded — the sharded path on a (1, 1) mesh over a one-rank NCCL
             group: smollm-135m's training steps, mamba2-130m's prefill and
             deepseek-moe-16b's loss and backward at 2 of 28 layers with
             DTensor parameters under ``shard_ctx``, bitwise the same runs
             unsharded, and ``all_reduce_int8`` over the data axis.
16. dryrun  — the dry-run (``repro_torch.launch.dryrun``).  Its unsharded
             prediction on meta tensors against real steps on the card at
             published widths and depth: smollm-135m training at phase 5's
             cell (8 x 2048, block remat, AdamW) and mamba2-130m's prefill
             (8 x 2048).  With ``use_kernels="off"`` (the path the trace
             runs): argument bytes exactly the real inputs', the predicted
             peak within 15% of ``max_memory_allocated`` over a step (reset
             before it), the predicted FLOPs within 1% of
             ``FlopCounterMode`` on the step (the ops that differ printed
             otherwise); with ``"cuda"``: the kernels launched, the peak.
             For both paths the device ms of a step (``profile_window``) and
             ``step_mfu``, the model FLOPs over those seconds at the H100
             SXM's dense bf16 peak (989 TFLOP/s).  Meanwhile, one process a
             cell on the host's CPU: ``python -m repro_torch.launch.dryrun``
             over smollm-135m x {train_4k, prefill_32k, decode_32k} and
             mamba2-130m train_4k at 16x16 and deepseek-moe-16b decode_32k at
             2x16x16 on a ``fake`` process group of 256 / 512 ranks, every
             cell ``ok``: FLOPs, collective bytes (ICI / DCN), argument and
             temp GiB per device and trace seconds printed.
17. examples — the six example twins (``examples/*_torch.py``), each
             through its ``main`` on the card, each passing its own checks
             and launching each kernel of its path (counts set to 0 just
             before a twin, or each of its runs, and read just after):
             heterogeneous_stream (Bitonic8 and IDCT8, n 1000, block 4096;
             the stream kernel), partition_explore (TopFilter n 20000:
             profile, explore, the best XCF run on the card, bitwise the
             host run; TopFilter has no fused region, so no stream kernel),
             serve_decode ``--full`` (smollm-135m, mamba2-130m and
             deepseek-moe-16b at published widths and depth, B 4, prompt
             16, 16 new; RMSNorm on each, the SSD scan, ``moe_gmm``),
             train_smollm ``--full --steps 80`` (B 16 x S 128, accum 2,
             checkpoints at 25, 50, 75, the failure injected at 60; flash
             and RMSNorm), quickstart (300 steps under ``shard_ctx`` on a
             one-rank NCCL mesh, then generation) and pipeline_lm as a
             subprocess (4 gloo ranks sharing the card, the hops staged
             through the host; each rank prints its launches of one
             pipelined forward and of one gradient pass; forward and
             gradient within 1e-2 of the sequential ones); each twin's
             seconds and key numbers, and the whole run's seconds.

The line before the last is the card's name and power limit, the one before
that a JSON record of the kernels (each with its design); the last line is
``{"ok": true, "device": {...}}``, printed only when every check passed.
Exits non-zero without a result when CUDA is not available or the package is
missing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
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
TOKENS = {"main": 4 * 4096, "serve": 32 * 4 * 4096, "wide": 256 * 4 * 4096}
REPS = {"main": 200, "serve": 40, "wide": 10}
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


def perm24_program():
    """A perm of P = 24 (no divisor of a warp's 128 tokens, so the kernel
    stages the block's tokens), then matmul8 and clip: block unit 24."""
    from repro_torch.kernels.stream_fused import StreamOp, StreamProgram

    idx = np.random.default_rng(24).permutation(24)
    basis = np.linalg.qr(np.random.default_rng(1).normal(size=(8, 8)))[0].astype(np.float32)
    ops = (
        StreamOp("perm", (0,), 1, (idx,)),
        StreamOp("matmul8", (1,), 2, (basis,)),
        StreamOp("clip", (2,), 3, (-50.0, 50.0)),
    )
    return StreamProgram(n_inputs=1, n_regs=4, ops=ops, outputs=(3,))


def ties_program():
    """min2 and max2 of two wires: the +-0 ties phase 2 holds bitwise."""
    from repro_torch.kernels.stream_fused import StreamOp, StreamProgram

    return StreamProgram(2, 4, (StreamOp("min2", (0, 1), 2), StreamOp("max2", (0, 1), 3)),
                         (2, 3))


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


def queued_ms(fn, reps: int, spin_ms: float = 1.0) -> float:
    """ms per call on the device for a call not captured in a CUDA graph: a
    spin kernel holds the stream (about ``spin_ms`` of the card's clock per
    call) while the host queues ``reps`` calls, so the events time the
    device's work and not the host's."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * spin_ms * reps))
    return _events(lambda: [fn() for _ in range(reps)], reps)


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


def phase_kernel(programs, ties) -> dict:
    from repro_torch.kernels.stream_fused import kernel
    from repro_torch.kernels.stream_fused.ref import fused_stream_ref

    print("phase 2: generated stream kernels against their plain version on the card",
          flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    for seed, (name, prog) in enumerate(programs.items()):
        unit = kernel.plan(prog).unit
        for size, n in TOKENS.items():
            n -= n % unit  # a whole number of the program's blocks
            xs = seeded_inputs(prog, n, seed)
            got = kernel.fused_stream_cuda(xs, prog)
            want = fused_stream_ref(xs, prog)
            torch.cuda.synchronize()
            same, err = True, 0.0
            for g, w in zip(got, want):
                s, e = compare(g, w)
                same, err = same and s, max(err, e)
            check(same, f"kernel != plain version bitwise: {name} N={n}")
            del got, want
            reps = REPS[size]
            # the wide rows rotate through four copies of the inputs, so that
            # no launch finds its inputs in the card's 50 MB L2
            sets = itertools.cycle([xs] + [[x.clone() for x in xs]
                                           for _ in range(3 if size == "wide" else 0)])

            def launch():
                return kernel.fused_stream_cuda(next(sets), prog)

            def plain():
                return fused_stream_ref(next(sets), prog)

            def empty():
                kernel.empty_launch(xs, prog)

            ms, plain_ms = device_ms(launch, reps), device_ms(plain, reps)
            floor_ms = device_ms(empty, reps)
            k_call, p_call = call_ms(launch, reps), call_ms(plain, reps)
            nbytes = 4 * n * (prog.n_inputs + len(prog.outputs))
            flops = flops_per_token(prog) * n
            b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
            k, threads, blocks = kernel.launch_shape(kernel.plan(prog), n, sms)
            row = dict(
                program=name, N=n, bitwise=same, max_abs_err=err, kernel_ms=ms,
                plain_ms=plain_ms, launch_floor_ms=floor_ms, call_ms=k_call,
                plain_call_ms=p_call, bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                bound_share=max(b_bytes, b_ops) / ms, bytes=nbytes, flops=flops,
                groups_a_thread=k, threads=threads, blocks=blocks,
            )
            rows[(name, size)] = row
            print("  " + json.dumps(row), flush=True)
            del xs
        torch.cuda.empty_cache()
    # wires 4 bytes off a 16-byte boundary: the kernels' scalar loads and stores
    for seed, (name, prog) in enumerate(programs.items()):
        n = TOKENS["main"] - TOKENS["main"] % kernel.plan(prog).unit
        xs = [torch.cat([x.new_zeros(1), x])[1:] for x in seeded_inputs(prog, n, seed)]
        got = kernel.fused_stream_cuda(xs, prog)
        same = all(compare(g, w)[0] for g, w in zip(got, fused_stream_ref(xs, prog)))
        check(same and xs[0].data_ptr() % 16 == 4,
              f"kernel != plain version bitwise on unaligned wires: {name}")
    print(f"  unaligned wires (scalar loads): bitwise for {list(programs)}", flush=True)
    # lane-major stacks, as a batched serve round hands them: 32 lanes of 4
    # chunks, one (128, block) wire a port, block a multiple of the unit
    for seed, (name, prog) in enumerate(programs.items()):
        block = SERVE_BLOCK - SERVE_BLOCK % kernel.plan(prog).unit
        xs = [x.view(128, block) for x in seeded_inputs(prog, 128 * block, seed)]
        got = kernel.fused_stream_cuda(xs, prog)
        same = all(g.shape == (128, block) and compare(g, w)[0]
                   for g, w in zip(got, fused_stream_ref(xs, prog)))
        check(same, f"kernel != plain version bitwise on a (128, {block}) lane stack: {name}")
    print(f"  lane-major (128, block) stacks: bitwise for {list(programs)}", flush=True)
    # +-0 ties through min2/max2: what the card does, held bitwise
    a = torch.tensor([0.0, -0.0] * 4, device="cuda")
    b = torch.tensor([-0.0, 0.0] * 4, device="cuda")
    kmin, kmax = kernel.fused_stream_cuda([a, b], ties)
    pmin, pmax = fused_stream_ref([a, b], ties)
    cmin, cmax = fused_stream_ref([a.cpu(), b.cpu()], ties)
    torch.cuda.synchronize()

    def signs(t):
        return "".join("-" if torch.signbit(v) else "+" for v in t[:2].cpu())

    for k_, p in ((kmin, pmin), (kmax, pmax)):
        check(compare(k_, p)[0], "kernel != plain version on +-0 ties")
    print(
        "  zero ties (a=[+0,-0], b=[-0,+0]): "
        f"min kernel {signs(kmin)} plain-cuda {signs(pmin)} plain-cpu {signs(cmin)}; "
        f"max kernel {signs(kmax)} plain-cuda {signs(pmax)} plain-cpu {signs(cmax)}",
        flush=True,
    )
    return rows


def build_net(nets, name: str, size: int):
    return nets[name](n=size) if name == "FIR32" else nets[name](size)


def run_net(nets, name, **kw):
    import repro_torch

    net, got = build_net(nets, name, SIZES[name])
    prog = repro_torch.compile(net, **kw)
    report = prog.run()
    return list(got), report, prog


def phase_e2e(nets) -> dict:
    import repro_torch
    from repro_torch.core.xcf import make_xcf
    from repro_torch.kernels.stream_fused import kernel

    print("phase 3: end to end, the main path", flush=True)
    kernel.LAUNCHES = 0  # the count covers the main path's runs only
    main, launches, loads = {}, {}, []
    for name in SIZES:
        before, built = kernel.LAUNCHES, len(kernel.BUILDS)
        out, rep, prog = run_net(nets, name, backend="device", block=BLOCK)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches[name] = kernel.LAUNCHES - before
        main[name] = (out, rep, prog)
        # every program this run compiled (plan, emit, build or load) was
        # done before run() began
        for t0, t1, lib in kernel.BUILDS[built:]:
            loads.append(dict(network=name, library=lib, seconds=t1 - t0,
                              before_run_s=t_end - rep.seconds - t1))
            check(t1 <= t_end - rep.seconds,
                  f"{name}: kernel {lib} compiled inside RunReport.seconds")
    print(f"  kernel launches on the main path: {launches}", flush=True)
    check(len(loads) == len(FUSED_NETS), f"{len(loads)} programs compiled, not one a network")
    print(f"  programs compiled with the partitions (off the run's clock): {loads}", flush=True)
    for name, (out, rep, prog) in main.items():
        dp = prog.device_program()
        per_launch = fused_regions(prog) * (1 if dp.flat_megastep else dp.megastep_k)
        check(launches[name] == rep.plink_launches * per_launch,
              f"{name}: {launches[name]} stream-kernel launches for {rep.plink_launches} "
              f"PLink launches of {fused_regions(prog)} fused regions")

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
            if "stream_fused_kernel" in ev.key:
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
    # name: (B, S, H, KV, hd, dtype, causal)
    "path": (8, 2048, 9, 3, 64, torch.bfloat16, True),
    "f32": (2, 512, 4, 2, 64, torch.float32, True),
    "hd128": (2, 1024, 32, 8, 128, torch.bfloat16, True),
    # S % 128 == 64: the bf16 forward's 128-row blocks and dK/dV's 128-key
    # blocks end half past the sequence
    "hd16": (2, 192, 4, 2, 16, torch.bfloat16, True),
    "hd32": (2, 192, 4, 2, 32, torch.bfloat16, True),
    "full": (2, 1024, 8, 2, 64, torch.bfloat16, False),
    # phase 17's twins: pipeline_lm's microbatch and its sequential forward
    # (S 64, one block short of 128 rows), quickstart's and train_smollm's steps
    "pipeline_lm": (2, 64, 4, 2, 16, torch.bfloat16, True),
    "sequential_lm": (8, 64, 4, 2, 16, torch.bfloat16, True),
    "quickstart": (16, 128, 4, 2, 32, torch.bfloat16, True),
    "train_smollm": (8, 128, 9, 3, 64, torch.bfloat16, True),
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


def flash_bounds(B, S, H, KV, hd, dtype, causal: bool = True) -> dict:
    """Least time (ms) for each kernel's work: matrix FLOPs over the peak for
    the type, or bytes (each input read once, each output written once) over
    HBM bandwidth, whichever is larger."""
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S  # (query, key) pairs
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


def ptxas_entries(log: str, name: str) -> dict:
    """From nvcc's ``-Xptxas -v`` report, each entry function whose
    (mangled) name holds ``name``: its registers, spill stores (bytes) and
    the codes of ptxas's notes that it serialised the function's wgmmas
    (C7512: too few registers; C7520: a divergent path around them)."""
    out, cur = {}, None

    def entry(fn):
        return out.setdefault(fn, {"registers": None, "spill_stores": 0, "serialised": []})

    for line in log.splitlines():
        if "(C75" in line and "serialized" in line and "'" in line:
            fn = line.split("'")[-2]
            if name in fn:
                entry(fn)["serialised"].append(line[line.index("(C75") + 1:][:5])
        elif "Compiling entry function" in line or "Function properties for" in line:
            cur = line.split("'")[1] if "'" in line else line.split("for ")[-1].strip()
            cur = cur if name in cur else None
            if cur is not None:
                entry(cur)
        elif cur is not None and "bytes spill stores" in line:
            out[cur]["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif cur is not None and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(line.split("Used")[1].split("registers")[0])
    return out


def check_ptxas(log: str, name: str, strict) -> None:
    """Print the ptxas line of every entry function named like ``name`` and
    fail the run where one for which ``strict(mangled)`` holds spills or has
    its wgmmas serialised."""
    entries = ptxas_entries(log, name)
    check(bool(entries), f"ptxas: no entry function named like {name} in the build report")
    for fn, rep in sorted(entries.items()):
        short = fn[fn.index(name):].split("EE")[0]  # the name and its template arguments
        print(f"  ptxas {short}: {rep['registers']} registers, "
              f"{rep['spill_stores']} bytes spill stores, wgmmas serialised: "
              f"{','.join(rep['serialised']) or 'no'}", flush=True)
        if strict(fn):
            check(rep["spill_stores"] == 0, f"ptxas: {fn} spills {rep['spill_stores']} bytes")
            check(not rep["serialised"], f"ptxas: {fn} has its wgmmas serialised "
                                         f"({','.join(rep['serialised'])})")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return bool(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol))


def phase_flash() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ref
    from repro_torch.kernels.flash_attention.ops import flash_attention

    print("phase 4: flash kernels against their plain versions on the card", flush=True)
    kernel.LIBRARY.build()
    # the backward kernels must neither spill nor have their wgmmas serialised
    # at the path's hd 64; the forward (C7520) and the other hd are printed
    for name in ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel"):
        check_ptxas(kernel.LIBRARY.log, name, lambda fn: "flash_bwd" in fn and "ILi64E" in fn)
    rows = {}
    for shape, (B, S, H, KV, hd, dtype, causal) in FLASH_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(len(rows))

        def randn(*size):
            return torch.randn(*size, generator=gen, device="cuda", dtype=torch.float32).to(dtype)

        q, do = randn(B * H, S, hd), randn(B * H, S, hd)
        k, v = randn(B * KV, S, hd), randn(B * KV, S, hd)
        tol_f, tol_b = FLASH_TOL[dtype]

        o_k, lse_k = kernel.flash_fwd_cuda(q, k, v, causal=causal)
        o_p, lse_p = ref.flash_fwd_ref(q, k, v, causal=causal)
        delta = ref.delta_of(o_p, do)
        dq_k = kernel.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, causal=causal)
        dq_p = ref.flash_bwd_dq_ref(q, k, v, do, lse_p, delta, causal=causal)
        dk_k, dv_k = kernel.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, causal=causal)
        dk_p, dv_p = ref.flash_bwd_dkv_ref(q, k, v, do, lse_p, delta, causal=causal)
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
            "flash_fwd": (lambda: kernel.flash_fwd_cuda(q, k, v, causal=causal),
                          lambda: ref.flash_fwd_ref(q, k, v, causal=causal)),
            "flash_bwd_dq": (
                lambda: kernel.flash_bwd_dq_cuda(q, k, v, do, lse_p, delta, causal=causal),
                lambda: ref.flash_bwd_dq_ref(q, k, v, do, lse_p, delta, causal=causal)),
            "flash_bwd_dkv": (
                lambda: kernel.flash_bwd_dkv_cuda(q, k, v, do, lse_p, delta, causal=causal),
                lambda: ref.flash_bwd_dkv_ref(q, k, v, do, lse_p, delta, causal=causal)),
        }
        bounds = flash_bounds(B, S, H, KV, hd, dtype, causal)
        times = {}
        for name, (kern, plain) in calls.items():
            times[name] = (device_ms(kern, reps_for(kern)), device_ms(plain, reps_for(plain)))

        # the library yardstick, never called by the port
        q4, k4, v4 = q.view(B, H, S, hd), k.view(B, KV, S, hd), v.view(B, KV, S, hd)

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=True)

        sdpa_ms = device_ms(sdpa, reps_for(sdpa))
        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q4, k4, v4))
        do4 = do.view(B, H, S, hd)

        def sdpa_fb():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        qs = q.view(B, H, S, hd).transpose(1, 2).detach().requires_grad_(True)
        ks = k.view(B, KV, S, hd).transpose(1, 2).detach().requires_grad_(True)
        vs = v.view(B, KV, S, hd).transpose(1, 2).detach().requires_grad_(True)
        dos = do4.transpose(1, 2)

        def ours_fb():
            out = flash_attention(qs, ks, vs, causal=causal)
            torch.autograd.grad(out, (qs, ks, vs), dos)

        # SDPA's backward alone: one autograd.grad on a retained graph, its
        # device time (queued behind a spin kernel; host time hid it at
        # small shapes and on slow hosts)
        out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)

        def sdpa_bwd():
            torch.autograd.grad(out_g, (qg, kg, vg), do4, retain_graph=True)

        sdpa_bwd_ms = queued_ms(sdpa_bwd, reps_for(sdpa_bwd))
        del out_g
        sdpa_fb_ms = call_ms(sdpa_fb, reps_for(sdpa_fb))
        ours_fb_ms = call_ms(ours_fb, reps_for(ours_fb))
        library = {"flash_fwd": ("SDPA fwd", sdpa_ms),
                   "flash_bwd_dq": ("SDPA bwd (dQ+dK+dV)", sdpa_bwd_ms),
                   "flash_bwd_dkv": ("SDPA bwd (dQ+dK+dV)", sdpa_bwd_ms)}
        for name in FLASH_NAMES:
            row = dict(
                shape=shape, kernel=name, B=B, S=S, H=H, KV=KV, hd=hd, dtype=str(dtype),
                causal=causal, max_abs_err=errs[name], ms=times[name][0],
                plain_ms=times[name][1], **bounds[name],
                library=library[name][0], library_ms=library[name][1],
            )
            rows[(shape, name)] = row
            print("  " + json.dumps(row), flush=True)
        print("  " + json.dumps(dict(
            shape=shape, sdpa_fwd_ms=sdpa_ms, sdpa_bwd_call_ms=sdpa_bwd_ms,
            sdpa_fwd_bwd_call_ms=sdpa_fb_ms,
            port_fwd_bwd_call_ms=ours_fb_ms,
        )), flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 5: LM training, the slice's main path
# ---------------------------------------------------------------------------

TRAIN = dict(arch="smollm-135m", steps=10, global_batch=8, seq_len=2048)


def lm_counts() -> dict:
    """The launch counts of the LM path's kernels."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd_scan import kernel as ssd

    return {"flash_fwd": flash.FWD_LAUNCHES, "flash_bwd_dq": flash.DQ_LAUNCHES,
            "flash_bwd_dkv": flash.DKV_LAUNCHES, "rmsnorm": rms.LAUNCHES,
            "ssd_scan": ssd.LAUNCHES, "moe_gmm": gmm.LAUNCHES}


def zero_lm_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd_scan import kernel as ssd

    flash.FWD_LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0
    rms.LAUNCHES = ssd.LAUNCHES = gmm.LAUNCHES = 0


# what the host calls to put work on the device, as the profiler names it
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaMemcpyAsync", "cudaMemsetAsync")


# device work that copies or casts: what a float32 copy of a cache would run as
COPY_KERNELS = ("copy", "elementwise", "Memcpy")


PROFILE_ATTEMPTS = 3


def profile_window(run, n: int, *, warmup: bool = True, match=()) -> dict:
    """Device busy time and idle share over ``n`` calls of ``run``, from
    torch.profiler's CUDA activity (each kernel counted once).  With
    ``warmup``, one more call runs first under the profiler's schedule, traced
    and discarded, and the active window has 50 ms of idle margin at each
    end: a window without them loses kernel records.  ``records`` counts the
    device activities recorded (kernels, copies, fills), ``enqueued`` the
    host calls that put work on the device; a warm-up window that still
    recorded fewer (seen on a slow host) is taken again, up to
    ``PROFILE_ATTEMPTS`` times, and ``attempt`` says which one is returned.
    ``matched`` sums, per name in ``match``, the device time of kernels whose
    name holds it; ``longest_copy_us`` is the longest mean launch of a copy
    or elementwise kernel (``COPY_KERNELS``)."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        row = _profile_once(run, n, warmup, match)
        row["attempt"] = attempt
        if not warmup or row["records"] >= row["enqueued"]:
            break
    return row


def check_window(prof: dict, what: str) -> None:
    """Print a warm-up window's device records beside what the host enqueued,
    and fail the run if the window lost any."""
    print(f"  {what}: {prof['records']} device records for {prof['enqueued']} "
          f"enqueued by the host (attempt {prof['attempt']})", flush=True)
    check(prof["records"] >= prof["enqueued"],
          f"{what}: the profiled window lost kernel records after {prof['attempt']} attempts")


def _profile_once(run, n: int, warmup: bool, match) -> dict:
    acts = [torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=n, repeat=1) if warmup else None
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        if warmup:
            run()
            torch.cuda.synchronize()
            prof.step()
            time.sleep(0.05)
        t0 = time.perf_counter()
        for i in range(n):
            run()
            if i == n - 1:
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if warmup:
                    time.sleep(0.05)
            if warmup:
                prof.step()
    busy_us = longest_copy_us = 0.0
    records = enqueued = 0
    matched = {name: [0.0, 0] for name in match}
    by_kernel = []
    for ev in prof.key_averages():
        if ev.key.startswith("ProfilerStep"):  # the schedule's step spans, not kernels
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0.0) if us is None else us
        busy_us += us
        by_kernel.append((us, ev.count, ev.key))
        records += ev.count if us > 0 else 0
        enqueued += ev.count if ev.key in ENQUEUE_CALLS else 0
        if us > 0 and any(w in ev.key for w in COPY_KERNELS):
            longest_copy_us = max(longest_copy_us, us / ev.count)
        for name in match:
            if name in ev.key:
                matched[name][0] += us
                matched[name][1] += ev.count
    top = [dict(us_per_call=us / n, per_call=c / n, kernel=key[:90])
           for us, c, key in sorted(by_kernel, reverse=True)[:10]]
    return dict(calls=n, warmup=warmup, ms_per_call=secs / n * 1e3,
                device_busy_ms_per_call=busy_us / n / 1e3,
                idle_share=1.0 - busy_us / 1e6 / secs, records=records, enqueued=enqueued,
                longest_copy_us=longest_copy_us,
                matched={k: dict(ms_per_call=us / n / 1e3, launches_per_call=c / n)
                         for k, (us, c) in matched.items()},
                top_kernels=top)


F32_GEMMS = ("sgemm", "gemm_f32f32_f32f32")  # cuBLAS's float32 GEMM kernels


def phase_train() -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import run_training
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, init_opt_state

    print("phase 5: LM training, the main path", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        zero_lm_counts()
        out = run_training(
            TRAIN["arch"], reduced=False, steps=TRAIN["steps"],
            global_batch=TRAIN["global_batch"], seq_len=TRAIN["seq_len"],
            ckpt_dir=ckpt, log_every=1, device="cuda",
        )
        torch.cuda.synchronize()
        launches = {k: v for k, v in lm_counts().items() if k not in ("ssd_scan", "moe_gmm")}
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
    # flash_fwd_wgmma_kernel<64>, flash_bwd_dq_wgmma_kernel<64>, ...
    prof = profile_window(lambda: step_k(params, opt_state, batch), 3,
                          match=tuple(f"{name}_" for name in FLASH_NAMES))
    print("  " + json.dumps({"profiled": prof}), flush=True)
    check_window(prof, "train: profiled window")
    per_kernel = {name: prof["matched"][f"{name}_"]["ms_per_call"] for name in FLASH_NAMES}
    print("  flash ms per training step: " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in per_kernel.items())
        + f"; all {sum(per_kernel.values()):.3f}", flush=True)
    row["profiled"] = prof
    # the LM head's forward is a bf16 product with a float32 result: no
    # float32 GEMM runs once a CE chunk and again in its recompute
    head_f32 = [k for k in prof["top_kernels"]
                if any(p in k["kernel"] for p in F32_GEMMS) and k["per_call"] >= 8]
    print(f"  head: device busy {prof['device_busy_ms_per_call']:.1f} ms a step, "
          f"{row['tokens_per_s']:.0f} tokens/s; float32 GEMMs launched 8+ times a step among "
          f"the top kernels: {head_f32}", flush=True)
    check(not head_f32, "train: a float32 GEMM of the LM head's forward is among the top kernels")

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


# ---------------------------------------------------------------------------
# Phase 6: the RMSNorm and SSD scan kernels against their plain versions
# ---------------------------------------------------------------------------

NORM_SHAPES = {
    # name: (R, d, dtype)
    "prefill768_bf16": (16384, 768, torch.bfloat16),
    "prefill1536_bf16": (16384, 1536, torch.bfloat16),
    "decode768_bf16": (8, 768, torch.bfloat16),
    "decode1536_bf16": (8, 1536, torch.bfloat16),
    "smollm576_bf16": (16384, 576, torch.bfloat16),
    "decode576_bf16": (8, 576, torch.bfloat16),
    "prefill2048_bf16": (16384, 2048, torch.bfloat16),  # deepseek-moe-16b
    "decode2048_bf16": (8, 2048, torch.bfloat16),
    "scalar771_bf16": (16384, 771, torch.bfloat16),  # d % 8 != 0: the scalar instantiation
    "decode771_bf16": (8, 771, torch.bfloat16),  # the scalar instantiation, 8 warps a row
    "wide40000_bf16": (8, 40000, torch.bfloat16),  # wider than 8 warps' registers: 2 passes
    "wide100000_f32": (8, 100000, torch.float32),  # 7 passes
    "prefill768_f32": (16384, 768, torch.float32),
    "prefill1536_f32": (16384, 1536, torch.float32),
    # phase 17's twins: rows of 8 and 16 vectors, most lanes of a warp idle
    "pipeline64_bf16": (128, 64, torch.bfloat16),  # pipeline_lm's microbatch (few rows)
    "sequential64_bf16": (512, 64, torch.bfloat16),  # its sequential forward
    "quickstart128_bf16": (2048, 128, torch.bfloat16),  # quickstart's training step
    "prompt128_bf16": (19, 128, torch.bfloat16),  # quickstart's prompt
    "decode128_bf16": (1, 128, torch.bfloat16),  # quickstart's decode
}
NORM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}  # the reference's kernel tests
SSD_SHAPES = {
    # name: (B, S, nh, P, N, chunk, dtype)
    "path": (8, 2048, 24, 64, 128, 256, torch.bfloat16),
    "ragged": (2, 192, 3, 40, 24, 64, torch.bfloat16),  # P, N zero-padded; TMA
    "threads": (1, 192, 2, 33, 20, 96, torch.bfloat16),  # P, N % 8 != 0: no TMA; Q % 64 != 0
    "f32": (2, 512, 24, 64, 128, 256, torch.float32),
    "small_f32": (2, 256, 4, 32, 16, 64, torch.float32),
}
# against the plain version: float32 sums in another order (2e-3, the
# reference's SSD tolerance); a bf16 y differs by about one rounding of the
# output and of the tensor-core operands (csrc/ssd_scan.cu)
SSD_TOL = {torch.bfloat16: (2e-2, 2e-3), torch.float32: (2e-3, 2e-3)}  # (y, state)
# da > 0 on every second head, a_cs rising by a few units a chunk: the bf16
# kernels take W and the entering state as bf16 pairs there (csrc/ssd_scan.cu)
SSD_RISING = (2, 512, 4, 64, 128, 256, torch.bfloat16)
# the bf16 backward kernels against ref.ssd_scan_bwd_ref in float32 on the
# same bf16 inputs: the path, the mamba2-130m training cell's call (B 24), da >
# 0 on every second head, da = -2 everywhere (exp of the segment sums above
# the diagonal overflows: the gradients stay finite), P and N zero-padded
# (TMA) and staged by threads
SSD_BWD_SHAPES = {
    # name: (B, S, nh, P, N, chunk, decay: None, "rising" or "steep")
    "path": (8, 2048, 24, 64, 128, 256, None),
    "cell": (24, 2048, 24, 64, 128, 256, None),
    "rising": (2, 512, 4, 64, 128, 256, "rising"),
    "steep": (1, 512, 2, 64, 128, 256, "steep"),
    "ragged": (2, 192, 3, 40, 24, 64, None),
    "threads": (1, 192, 2, 33, 20, 96, None),
}
# the largest error over the largest magnitude of the reference's output:
# dx, dB and dC are rounded once to bf16 (2^-8 relative) after sums of
# products whose rounded operands (W, the entering state, as the forward
# takes them) add about as much; ddt and dA are float32 sums of those
# (sound runs: dx, dB, dC up to 4.9e-3, ddt 3.7e-4, dA 1.9e-3)
SSD_BWD_TOL = {"dx": 1e-2, "ddt": 2e-3, "dA": 5e-3, "dB": 1e-2, "dC": 1e-2}


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS_PER_S) -> dict:
    b_ops, b_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(b_ops, b_bytes),
                bound_by="operations" if b_ops >= b_bytes else "bytes")


def bench_module(rel: str):
    """A module of the benchmark, loaded from its file under ``bench/`` (its
    own ``bench.*`` imports resolved from the repo root), so that a count
    here is the benchmark's and the two cannot drift apart."""
    import importlib.util

    root = Path(__file__).resolve().parent
    path = root / "bench" / rel
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(root))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(root))
    return mod


def ssd_work(B, S, nh, P, N, chunk, dtype) -> dict:
    """FLOPs the function needs on this run's shape, and the bytes each input
    is read and each output written once: the benchmark's count
    (``bench/work/kernels.py::ssd_scan``, which ``ssd_scan_roofline`` reads).
    ``bound_ms`` takes the products at the rate of the unit the design runs
    them on: the bf16 tensor cores (989 TFLOP/s; the state update's bf16
    pair is two products there, counted once as the function's work) for
    bfloat16, float32 outside the tensor cores (67) for float32.
    ``bound_f32_ms`` is every product at 67 TFLOP/s, the bound of the
    CUDA-core design."""
    flops, nbytes, _ = bench_module("work/kernels.py").ssd_scan(
        B, S, nh, P, N, chunk, str(dtype).removeprefix("torch."))
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    unit = "bf16 tensor cores" if dtype == torch.bfloat16 else "float32 CUDA cores"
    return dict(bound(flops, nbytes, peak), bound_unit=unit,
                bound_f32_ms=bound(flops, nbytes)["bound_ms"])


def heads_first(t):
    """(B, S, nh, ...) -> (B nh, S, ...), the layout of ``ref.ssd_scan_ref``
    and ``ref.ssd_scan_bwd_ref``."""
    B, S, nh = t.shape[:3]
    return t.transpose(1, 2).reshape(B * nh, S, *t.shape[3:])


def ssd_inputs(B, S, nh, P, N, dtype, seed):
    """The reference's kernel-test distribution (tests/test_kernels.py), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, generator=g, device="cuda", dtype=torch.float32)

    x = randn(B, S, nh, P).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, nh)) * 0.1
    A = -torch.exp(randn(nh) * 0.5)
    return x, dt, A, (randn(B, S, N) * 0.3).to(dtype), (randn(B, S, N) * 0.3).to(dtype)


def ssd_bwd_work(B, S, nh, P, N, chunk) -> dict:
    """FLOPs and bytes of one bf16 backward call, the benchmark's count: the
    ``work`` of ``bench/metrics/ssd_bwd_roofline.train.py``, which
    ``ssd_bwd_roofline.train`` reads (``bench_module``)."""
    mod = bench_module("metrics/ssd_bwd_roofline.train.py")
    flops, nbytes, _ = mod.work(B, S, nh, P, N, chunk, "bfloat16")
    return bound(flops, nbytes, BF16_FLOPS_PER_S)


def ssd_bwd_check(ssd) -> dict:
    """The bf16 backward kernels (``kernel.ssd_scan_bwd_cuda``) against
    ``ref.ssd_scan_bwd_ref`` in float32 on the same bf16 inputs, with and
    without the final state's cotangent, at ``SSD_BWD_SHAPES`` within
    ``SSD_BWD_TOL``; two calls give the same bits.  At the path: its time,
    each kernel's, the plain vjp's (the vjp of ``ssd_chunked``) and the bound."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
    from repro_torch.model.ssm import ssd_chunked

    check_ptxas(ssd.LIBRARY.log, "ssd_bwd", lambda fn: True)
    # both entries refuse a folded (B nh, S, P) x, in their own check
    x, dt, A, B_, C_ = ssd_inputs(1, 64, 2, 16, 16, torch.bfloat16, 399)
    xf, dtf = heads_first(x).contiguous(), heads_first(dt).contiguous()
    for what, call in (
            ("forward", lambda: ssd.ssd_scan_cuda(xf, dtf, dtf * A[:, None], B_, C_, chunk=64)),
            ("backward", lambda: ssd.ssd_scan_bwd_cuda(xf, dtf, dtf * A[:, None], A, B_, C_, xf,
                                                       None, chunk=64))):
        try:
            call()
            said = None
        except ValueError as e:
            said = str(e)
        check(said is not None and "ssd_scan kernel: x is" in said,
              f"ssd_scan {what}: a folded x was not refused by its check ({said})")
    rows = {}
    for seed, (shape, (B, S, nh, P, N, chunk, decay)) in enumerate(SSD_BWD_SHAPES.items()):
        x, dt, A, B_, C_ = ssd_inputs(B, S, nh, P, N, torch.bfloat16, 400 + seed)
        if decay == "rising":
            A = torch.where(torch.arange(nh, device="cuda") % 2 == 1, -0.05 * A, A)
        elif decay == "steep":
            dt, A = torch.full_like(dt, 0.5), torch.full_like(A, -4.0)
        g = torch.Generator(device="cuda").manual_seed(500 + seed)
        dtf = heads_first(dt).contiguous()
        daf = dtf * A.repeat(B)[:, None]
        dy = torch.randn(B, S, nh, P, generator=g, device="cuda").to(torch.bfloat16)
        ds = torch.randn(B * nh, P, N, generator=g, device="cuda")
        row = dict(shape=shape, B=B, S=S, nh=nh, P=P, N=N, chunk=chunk,
                   plan=[st.grid for st in ssd.ssd_bwd_plan(B * nh, S, P, N, nh, chunk).stages])

        for dstate in (ds, None):
            got = ssd.ssd_scan_bwd_cuda(x, dtf, daf, A, B_, C_, dy, dstate, chunk=chunk)
            again = ssd.ssd_scan_bwd_cuda(x, dtf, daf, A, B_, C_, dy, dstate, chunk=chunk)
            want = ssd_scan_bwd_ref(heads_first(x.float()), dtf, A, B_.float(), C_.float(),
                                    heads_first(dy.float()), dstate, nheads=nh, chunk=chunk)
            want = (want[0].reshape(B, nh, S, P).transpose(1, 2), *want[1:])
            torch.cuda.synchronize()
            tag = "dstate" if dstate is not None else "no_dstate"
            errs = {}
            for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
                errs[name] = max_err(a, b) / max(float(b.abs().max()), 1e-30)
                check(bool(torch.isfinite(a).all()),
                      f"ssd_scan_bwd {shape} {tag}: non-finite kernel {name}")
                check(errs[name] <= SSD_BWD_TOL[name],
                      f"ssd_scan_bwd {shape} {tag}: kernel {name} off the plain version by "
                      f"{errs[name]:.3g} of its largest value, over {SSD_BWD_TOL[name]}")
            same = all(bits_equal(a, b) for a, b in zip(got, again))
            check(same, f"ssd_scan_bwd {shape} {tag}: two calls differ in their bits")
            row[tag] = dict(rel_err=errs, same_bits=same)
            del got, again, want
        if shape == "path":
            def kern():
                return ssd.ssd_scan_bwd_cuda(x, dtf, daf, A, B_, C_, dy, ds, chunk=chunk)

            ins = [t.detach().clone().requires_grad_() for t in (x, dt, A, B_, C_)]
            gy, gs = dy, ds.reshape(B, nh, P, N)

            def plain():
                y, st = ssd_chunked(*ins, chunk)
                return torch.autograd.grad((y, st), ins, (gy, gs))

            stages = profile_window(kern, 5, match=tuple(
                st.kernel for st in ssd.ssd_bwd_plan(B * nh, S, P, N, nh, chunk).stages))
            row.update(ms=device_ms(kern, reps_for(kern)), plain_ms=queued_ms(plain, 3, spin_ms=80.0),
                       stage_ms={k: v["ms_per_call"] for k, v in stages["matched"].items()},
                       **ssd_bwd_work(B, S, nh, P, N, chunk))
        rows[shape] = row
        print("  " + json.dumps({"ssd_scan_bwd": row}), flush=True)
    return rows


def phase_norm_ssd():
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    print("phase 6: RMSNorm and SSD scan kernels against their plain versions", flush=True)
    rms.LIBRARY.build()
    ssd.LIBRARY.build()
    # strict on the instantiations this phase's shapes run
    used = set()
    for R, d, dtype in NORM_SHAPES.values():
        plan = rms.norm_plan(R, d, dtype)
        used.add(f"rmsnorm_kernelI{'13__nv_bfloat16' if dtype == torch.bfloat16 else 'f'}"
                 f"Li{plan.vec}ELi{plan.vecs_per_lane}E")
    check_ptxas(rms.LIBRARY.log, "rmsnorm_kernel", lambda fn: any(u in fn for u in used))
    # strict on the bf16 SSD kernels the path runs (TMA: ILb1E); the float32
    # kernel (the CUDA-core design) and the thread-staged chunk outputs are printed
    check_ptxas(ssd.LIBRARY.log, "ssd_", lambda fn: "f32" not in fn and "ILb0E" not in fn)
    norm_rows = {}
    for seed, (shape, (R, d, dtype)) in enumerate(NORM_SHAPES.items()):
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        x = torch.randn(R, d, generator=g, device="cuda").to(dtype)
        scale = torch.rand(d, generator=g, device="cuda") + 0.5
        got, want = rms.rmsnorm_cuda(x, scale), rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        tol = NORM_TOL[dtype]
        check(close(got, want, tol), f"rmsnorm {shape}: kernel not within {tol} of plain "
                                     f"(max abs err {max_err(got, want):.3g})")
        check(bool(torch.isfinite(got).all()), f"rmsnorm {shape}: non-finite kernel output")
        scale_x = scale.to(dtype)

        def kern():
            return rms.rmsnorm_cuda(x, scale)

        def plain():
            return rmsnorm_ref(x, scale)

        def lib():  # the library yardstick, never called by the port
            return F.rms_norm(x, (d,), scale_x, 1e-6)

        esz = torch.finfo(dtype).bits // 8
        plan = rms.norm_plan(R, d, dtype)
        row = dict(
            shape=shape, kernel="rmsnorm", R=R, d=d, dtype=str(dtype),
            plan=dict(warps_per_row=plan.warps_per_row, rows_per_block=plan.rows_per_block,
                      vecs_per_lane=plan.vecs_per_lane, vec=plan.vec),
            max_abs_err=max_err(got, want), ms=device_ms(kern, reps_for(kern, most=200)),
            plain_ms=device_ms(plain, reps_for(plain, most=200)),
            library_ms=device_ms(lib, reps_for(lib, most=200)),
            **bound(4 * R * d, 2 * R * d * esz + 4 * d),
        )
        norm_rows[shape] = row
        print("  " + json.dumps(row), flush=True)

    ssd_rows = {}
    for seed, (shape, (B, S, nh, P, N, chunk, dtype)) in enumerate(SSD_SHAPES.items()):
        x, dt, A, B_, C_ = ssd_inputs(B, S, nh, P, N, dtype, 200 + seed)
        xf, dtf = heads_first(x).contiguous(), heads_first(dt).contiguous()
        daf = dtf * A.repeat(B)[:, None]
        y_k, st_k = ssd.ssd_scan_cuda(x, dtf, daf, B_, C_, chunk=chunk)
        y_k = heads_first(y_k)  # as the plain version lays y out
        y_p, st_p = ssd_scan_ref(xf, dtf, daf, B_, C_, nheads=nh, chunk=chunk)
        torch.cuda.synchronize()
        tol_y, tol_s = SSD_TOL[dtype]
        for what, a, b, tol in (("y", y_k, y_p, tol_y), ("state", st_k, st_p, tol_s)):
            check(close(a, b, tol), f"ssd_scan {shape}: kernel {what} not within {tol} of "
                                    f"plain (max abs err {max_err(a, b):.3g})")
            check(bool(torch.isfinite(a).all()), f"ssd_scan {shape}: non-finite kernel {what}")

        def kern():
            return ssd.ssd_scan_cuda(x, dtf, daf, B_, C_, chunk=chunk)

        def plain():
            return ssd_scan_ref(xf, dtf, daf, B_, C_, nheads=nh, chunk=chunk)

        plan = ssd.ssd_plan(B * nh, S, P, N, nh, chunk, dtype,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        row = dict(
            shape=shape, kernel="ssd_scan", B=B, S=S, nh=nh, P=P, N=N, chunk=chunk,
            dtype=str(dtype), head_group=plan.head_group or None, tma=plan.tma,
            max_abs_err=max(max_err(y_k, y_p), max_err(st_k, st_p)),
            max_abs_err_y=max_err(y_k, y_p), max_abs_err_state=max_err(st_k, st_p),
            max_abs_y=float(y_p.float().abs().max()), max_abs_state=float(st_p.abs().max()),
            ms=device_ms(kern, reps_for(kern)), plain_ms=device_ms(plain, reps_for(plain)),
            library_ms=None, **ssd_work(B, S, nh, P, N, chunk, dtype),
        )
        if shape == "path":
            # each kernel of one call, from the profiler: its device time and
            # the kernels a call launches
            stages = profile_window(kern, 5, match=SSD_STAGES)["matched"]
            row["stage_ms"] = {k: v["ms_per_call"] for k, v in stages.items()}
            row["kernels_per_call"] = round(sum(v["launches_per_call"] for v in stages.values()))
            check(row["kernels_per_call"] == len(SSD_STAGES)
                  and all(v["launches_per_call"] == 1 for v in stages.values()),
                  f"ssd_scan path: the profiler saw {row['kernels_per_call']} kernels a call "
                  f"({ {k: v['launches_per_call'] for k, v in stages.items()} }), not one "
                  f"each of {SSD_STAGES}")
        ssd_rows[shape] = row
        print("  " + json.dumps(row), flush=True)

    # da > 0: L's factors and exp(a_cs) exceed 1 and the state grows; the
    # kernels take W and the entering state as bf16 pairs in those chunks.
    # Gated: finite outputs, y and the state within SSD_TOL.
    B, S, nh, P, N, chunk, dtype = SSD_RISING
    x, dt, A, B_, C_ = ssd_inputs(B, S, nh, P, N, dtype, 300)
    A = torch.where(torch.arange(nh, device="cuda") % 2 == 1, -0.05 * A, A)
    xf, dtf = heads_first(x).contiguous(), heads_first(dt).contiguous()
    daf = dtf * A.repeat(B)[:, None]
    y_k, st_k = ssd.ssd_scan_cuda(x, dtf, daf, B_, C_, chunk=chunk)
    y_k = heads_first(y_k)
    y_p, st_p = ssd_scan_ref(xf, dtf, daf, B_, C_, nheads=nh, chunk=chunk)
    tol_y, tol_s = SSD_TOL[dtype]
    check(bool(torch.isfinite(y_k).all() and torch.isfinite(st_k).all()),
          "ssd_scan rising: non-finite kernel output")
    check(close(st_k, st_p, tol_s), f"ssd_scan rising: kernel state not within {tol_s} of "
                                    f"plain (max abs err {max_err(st_k, st_p):.3g})")
    check(close(y_k, y_p, tol_y), f"ssd_scan rising: kernel y not within {tol_y} of "
                                  f"plain (max abs err {max_err(y_k, y_p):.3g})")
    err = (y_k.float() - y_p.float()).abs()
    print("  " + json.dumps({"ssd_scan_rising": dict(
        B=B, S=S, nh=nh, P=P, N=N, chunk=chunk, max_abs_err_y=float(err.max()),
        y_tol_share=float((err / (tol_y + tol_y * y_p.float().abs())).max()),
        max_abs_y=float(y_p.float().abs().max()), max_abs_err_state=max_err(st_k, st_p),
        a_cs_rise_per_chunk=float(daf.reshape(B * nh, -1, min(chunk, S)).sum(-1).max()))}),
        flush=True)
    return norm_rows, ssd_rows, ssd_bwd_check(ssd)


# ---------------------------------------------------------------------------
# Phase 7: LM serving, this slice's main path
# ---------------------------------------------------------------------------

SERVE = dict(arch="mamba2-130m", batch=8, prompt_len=2048, max_new=64)
NORMS_PER_FORWARD = {"mamba2-130m": 49, "smollm-135m": 61,  # block + gated + final
                     "deepseek-moe-16b": 57}
GMM_PER_FORWARD = {"deepseek-moe-16b": 84}  # gate, up, down per MoE layer
NEAR_TIE = 6e-2  # two logits each within 3e-2 (the decode tolerance) can swap
# bf16 at full width: the chunked prefill and the step-by-step decode (and the
# plain path's bf16 chunk weights) round at other points, and the drift grows
# with depth past the reference's 3e-2, which was set for 2 layers of d=64.
# tests/test_torch_bf16_drift.py shows the JAX model drifting as far as the
# port at full width on the CPU.  Float32, where only summation order
# differs, is held to the reference's tolerances.  The bf16 limit on logits
# (decode against the forward, and the kernel path against "off") lies
# between the sound runs' largest readings and their controls', runs with
# the carried state lost, over the prompts of these seeds; the run fails if
# a control does not exceed it.
BF16_LOGITS_TOL = 0.3
BF16_SEEDS = {"decode": (1, 11, 12), "kernels_vs_off": (2, 21, 22)}


def get_cfg(arch: str):
    from repro_torch.configs import get_config

    return get_config(arch)


def isolated(cfg, params, prompt, max_new, max_len, eos_id=2):
    """One request alone (batch 1): its tokens and each step's top-2 logit gap."""
    from repro_torch.launch.serve import prefill_cache
    from repro_torch.model import lm

    with torch.inference_mode():
        tokens = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")[None, :]
        logits, cache = prefill_cache(params, cfg, tokens, max_len)
        out, gaps = [], []
        pos = tokens.shape[1]
        while True:
            top = torch.topk(logits[0], 2).values
            out.append(int(torch.argmax(logits[0])))
            gaps.append(float(top[0] - top[1]))
            if out[-1] == eos_id or len(out) >= max_new or pos >= max_len - 1:
                return out, gaps
            logits, cache = lm.decode_step(
                params, cfg, cache, torch.tensor([out[-1]], dtype=torch.int32, device="cuda"),
                pos)
            pos += 1


def profiled_decode(cfg, params, n: int = 16, match=()) -> dict:
    """Device busy and idle share over ``n`` decode steps at the main path's
    batch, after a prefill of its prompt length (``profile_window``; the
    device time of the kernels named like ``match``)."""
    from repro_torch.launch.serve import prefill_cache
    from repro_torch.model import lm

    g = torch.Generator().manual_seed(7)
    prompts = torch.randint(3, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"]),
                            generator=g, dtype=torch.int32).cuda()
    cache_len = SERVE["prompt_len"] + PROFILE_ATTEMPTS * (n + 1) + 1  # room for every attempt
    logits, cache = prefill_cache(params, cfg, prompts, cache_len)
    state = dict(logits=logits, cache=cache, pos=SERVE["prompt_len"])

    def step():
        tok = torch.argmax(state["logits"], -1).to(torch.int32)
        state["logits"], state["cache"] = lm.decode_step(params, cfg, state["cache"], tok,
                                                         state["pos"])
        state["pos"] += 1

    with torch.inference_mode():
        prof = profile_window(step, n, match=match)
    prof["cache_len"] = cache_len
    check_window(prof, f"{cfg.name}: profiled decode")
    return prof


SSD_STAGES = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")  # one bf16 call's kernels


def profiled_prefill(cfg, params, n: int = 3) -> dict:
    """Device busy time of ``n`` prefills of the main path's prompts
    (``profile_window``), with the SSD scan's three kernels and RMSNorm's
    device time in it."""
    from repro_torch.launch.serve import prefill_cache

    g = torch.Generator().manual_seed(8)
    prompts = torch.randint(3, cfg.vocab_size, (SERVE["batch"], SERVE["prompt_len"]),
                            generator=g, dtype=torch.int32).cuda()

    def prefill():
        prefill_cache(params, cfg, prompts, SERVE["prompt_len"] + 1)

    prof = profile_window(prefill, n, match=(*SSD_STAGES, "rmsnorm_kernel"))
    check_window(prof, f"{cfg.name}: profiled prefill")
    ssd_ms = sum(prof["matched"][k]["ms_per_call"] for k in SSD_STAGES)
    print(f"  {cfg.name} prefill: {prof['device_busy_ms_per_call']:.2f} ms device busy, "
          f"ssd_scan {ssd_ms:.3f} ms, rmsnorm "
          f"{prof['matched']['rmsnorm_kernel']['ms_per_call']:.3f} ms", flush=True)
    return dict(prof, ssd_scan_ms=ssd_ms)


# the decode's attention products beyond the served shape: (kv heads, query
# heads per kv head, cache length), at the served batch and head width
DECODE_PRODUCT_SWEEP = ((16, 1, 512), (16, 1, 8192), (8, 4, 2048), (32, 1, 2048),
                        (64, 1, 2048))
DECODE_PRODUCT_TOL = 1e-5  # max |err| over max |plain|, float32 results


def decode_products(B: int, hd: int, shapes) -> list:
    """The decode's two attention products (``model/attention.py``:
    ``_cache_scores`` over every (kv head, key slot) pair with the diagonal
    blocks kept, ``_cache_mix`` with p spread block-diagonally) against their
    plain version (float32 casts, ``einsum``).  Device times beside the same
    products as one strided ``bmm`` per kv head (reads the cache as it lies
    with no waste, but launches kv times) and beside the bound: reading the
    K and V caches once."""
    from repro_torch.model import attention as A

    rows = []
    g = torch.Generator(device="cuda").manual_seed(13)
    for kv, G, S in shapes:
        ck, cv = (torch.randn(B, S, kv, hd, generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        q_g = torch.randn(B, kv, G, hd, generator=g, device="cuda").to(torch.bfloat16)
        scores = A._cache_scores(q_g, ck, False)
        p = torch.softmax(scores, -1).to(torch.bfloat16)
        mix = A._cache_mix(p, cv, False)

        def plain():
            return (torch.einsum("bkgd,bskd->bkgs", q_g.float(), ck.float()),
                    torch.einsum("bkgs,bskd->bkgd", p.float(), cv.float()))

        want_s, want_m = plain()
        err = max(float((scores - want_s).abs().max() / want_s.abs().max()),
                  float((mix - want_m).abs().max() / want_m.abs().max()))
        check(err <= DECODE_PRODUCT_TOL, f"decode products kv={kv} G={G} S={S}: relative "
                                         f"error {err:.3g} > {DECODE_PRODUCT_TOL}")
        del scores, mix, want_s, want_m

        def ours():
            A._cache_scores(q_g, ck, False)
            A._cache_mix(p, cv, False)

        def per_head():
            for h in range(kv):
                torch.bmm(q_g[:, h], ck[:, :, h].transpose(1, 2), out_dtype=torch.float32)
                torch.bmm(p[:, h], cv[:, :, h], out_dtype=torch.float32)

        row = dict(B=B, kv=kv, G=G, S=S, hd=hd, max_rel_err=err,
                   ms=device_ms(ours, reps_for(ours)),
                   per_head_ms=device_ms(per_head, reps_for(per_head)),
                   plain_ms=device_ms(plain, reps_for(plain)),
                   bound_ms=2 * ck.numel() * 2 / HBM_BYTES_PER_S * 1e3)
        print("  " + json.dumps({"decode_products": row}), flush=True)
        rows.append(row)
        del ck, cv, q_g, p
    return rows


def serve_main(arch: str, tag: str) -> dict:
    """One run_serving at full width, with the LM kernels' counts set to 0
    just before and read just after."""
    from repro_torch.launch.serve import run_serving

    torch.cuda.reset_peak_memory_stats()
    zero_lm_counts()
    out = run_serving(arch, reduced=False, batch=SERVE["batch"],
                      prompt_len=SERVE["prompt_len"], max_new=SERVE["max_new"],
                      device="cuda")
    torch.cuda.synchronize()
    launches = lm_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = out["steps"]
    row = dict(
        run=tag, arch=arch, batch=SERVE["batch"], prompt_len=SERVE["prompt_len"],
        steps=steps, prefill_seconds=out["prefill_seconds"],
        decode_seconds=out["decode_seconds"],
        prefill_tokens_per_s=SERVE["batch"] * SERVE["prompt_len"] / out["prefill_seconds"],
        decode_tokens_per_s=SERVE["batch"] * (steps - 1) / out["decode_seconds"],
        launches=launches, max_memory_allocated_gb=peak / 1e9,
    )
    print("  " + json.dumps(row), flush=True)
    o = out["output"]
    check(o.shape == (SERVE["batch"], SERVE["max_new"]), f"serve {arch}: output {o.shape}")
    check(bool(((o >= 0) & (o < get_cfg(arch).vocab_size)).all()),
          f"serve {arch}: tokens outside the vocabulary")
    # one forward for the prefill and one per decode step (steps - 1 of them)
    want_norms = NORMS_PER_FORWARD[arch] * steps
    check(launches["rmsnorm"] == want_norms,
          f"serve {arch}: {launches['rmsnorm']} rmsnorm launches, expected {want_norms}")
    want_ssd = get_cfg(arch).num_layers if arch == "mamba2-130m" else 0
    check(launches["ssd_scan"] == want_ssd,
          f"serve {arch}: {launches['ssd_scan']} ssd_scan launches, expected {want_ssd}")
    want_gmm = GMM_PER_FORWARD.get(arch, 0) * steps
    check(launches["moe_gmm"] == want_gmm,
          f"serve {arch}: {launches['moe_gmm']} moe_gmm launches, expected {want_gmm}")
    # the prefill's attention: one flash forward a layer; decode runs none
    want_flash = attention_layers(get_cfg(arch))
    check(launches["flash_fwd"] == want_flash,
          f"serve {arch}: {launches['flash_fwd']} flash_fwd launches, expected {want_flash}")
    return row


def attention_layers(cfg) -> int:
    from repro_torch.configs.base import MIXER_ATTN

    return sum(cfg.block_kind(i).mixer == MIXER_ATTN for i in range(cfg.num_layers))


# (B, S) of the attention layer alone: a multiple of kernel.TILE, then a
# length the prefill pads to the next multiple
FLASH_PREFILL_SHAPES = ((2, 2048), (2, 2000))


def flash_prefill(arch: str) -> dict:
    """A prefill's attention through the flash forward against the chunked
    plain path (``use_kernels="off"``) at the arch's published widths: one
    attention layer at each of ``FLASH_PREFILL_SHAPES`` (output within the
    forward kernel's bf16 tolerance, the returned cache bitwise the same,
    one forward launch), then whole prefills of 2 x 2048 (one forward a
    layer each, last logits within ``BF16_LOGITS_TOL``; the cache's distance
    from the plain path's is printed, since the layers after the first read
    hidden states that the two attentions round differently)."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.model import attention as attn
    from repro_torch.model import lm
    from repro_torch.model.layers import init_params

    cfg = get_cfg(arch)
    off = dataclasses.replace(cfg, use_kernels="off")
    tol = FLASH_TOL[torch.bfloat16][0]
    g = torch.Generator(device="cuda").manual_seed(1)
    layer = init_params(attn.attn_defs(cfg), 0, default_dtype=cfg.param_dtype, device="cuda")
    out = {"attention": []}
    with torch.inference_mode():
        for B, S in FLASH_PREFILL_SHAPES:
            x = torch.randn(B, S, cfg.d_model, generator=g, device="cuda").to(torch.bfloat16)
            pos = torch.arange(S, device="cuda")
            before = flash.FWD_LAUNCHES
            y, (k, v) = attn.attention(layer, x, cfg, pos, return_cache=True)
            n = flash.FWD_LAUNCHES - before
            y_o, (k_o, v_o) = attn.attention(layer, x, off, pos, return_cache=True)
            row = dict(B=B, S=S, launches=n, max_abs_err=max_err(y, y_o),
                       cache_equal=bool(torch.equal(k, k_o) and torch.equal(v, v_o)))
            out["attention"].append(row)
            check(n == 1, f"flash prefill {arch} S={S}: {n} forward launches, expected 1")
            check(close(y, y_o, tol), f"flash prefill {arch} S={S}: attention off "
                                      f"use_kernels='off' by {row['max_abs_err']:.3g}")
            check(row["cache_equal"], f"flash prefill {arch} S={S}: cache differs from 'off'")
        del layer
        params = lm.init_model(cfg, 0, device="cuda")
        tokens = torch.randint(3, cfg.vocab_size, (2, 2048), generator=g, device="cuda",
                               dtype=torch.int32)
        per_call = []
        for _ in range(2):
            before = flash.FWD_LAUNCHES
            logits, cache = lm.prefill(params, cfg, tokens=tokens)
            per_call.append(flash.FWD_LAUNCHES - before)
        logits_o, cache_o = lm.prefill(params, off, tokens=tokens)
    V = cfg.vocab_size
    ck, ck_o = cache["pos0"]["k"], cache_o["pos0"]["k"]
    out["prefill"] = dict(B=2, S=2048, launches_per_call=per_call,
                          logits_max_abs_err=max_err(logits[:, :V], logits_o[:, :V]),
                          cache_k_max_abs_err=max_err(ck, ck_o), cache_shape=list(ck.shape))
    want = attention_layers(cfg)
    check(per_call == [want] * 2, f"flash prefill {arch}: {per_call} forward launches a "
                                  f"prefill, expected {want}")
    check(bool(torch.isfinite(logits).all()), f"flash prefill {arch}: logits not finite")
    err = out["prefill"]["logits_max_abs_err"]
    check(err <= BF16_LOGITS_TOL, f"flash prefill {arch}: last logits off use_kernels='off' "
                                  f"by {err:.3g} > {BF16_LOGITS_TOL}")
    check(ck.shape == ck_o.shape, f"flash prefill {arch}: cache {tuple(ck.shape)} against "
                                  f"'off' {tuple(ck_o.shape)}")
    print("  " + json.dumps({"flash_prefill": out}), flush=True)
    del params
    return out


def full_logits(params, cfg, tokens) -> torch.Tensor:
    """The full forward's logits at every position, (B, S, V) float32."""
    from repro_torch.model import lm

    with torch.inference_mode():
        hidden, _, _ = lm.forward_hidden(params, cfg, tokens)
        logits = torch.matmul(hidden.float(), lm._head_w(params).float())
    return logits[..., :cfg.vocab_size]


def row_errs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max |a - b| over the last axis: one error per position."""
    return (a.float() - b.float()).abs().amax(-1).reshape(-1)


def quantiles(name: str, errs: torch.Tensor) -> dict:
    """The median, 90th percentile and largest of per-position errors."""
    q = torch.quantile(errs.float().cpu(), torch.tensor([0.5, 0.9, 1.0]))
    return {f"{name}_p50": float(q[0]), f"{name}_p90": float(q[1]),
            f"{name}_max": float(q[2]), f"{name}_count": int(errs.numel())}


def decode_consistency(cfg, params, tokens, S0: int, lose_state: bool = False) -> dict:
    """Prefill ``tokens[:, :S0]`` and teacher-forced decode of the rest
    against the full forward's logits (tests/test_lm_consistency.py).  With
    ``lose_state``, the control: the SSM states, or the attention keys and
    values, that the prefill hands to decode are zeroed, as a cache splice
    that dropped them would leave them."""
    from repro_torch.launch.serve import prefill_cache
    from repro_torch.model import lm

    B, S = tokens.shape
    V = cfg.vocab_size
    ref = full_logits(params, cfg, tokens)
    with torch.inference_mode():
        logits, cache = prefill_cache(params, cfg, tokens[:, :S0], S)
        err_p = max_err(logits[:, :V], ref[:, S0 - 1])
        p_ok, d_ok, errs = close(logits[:, :V], ref[:, S0 - 1], 2e-2), True, []
        pos_errs = [row_errs(logits[:, :V], ref[:, S0 - 1])]
        if lose_state:
            for leaves in cache.values():
                for name in ("state", "k", "v"):
                    if name in leaves:
                        leaves[name].zero_()
        for i in range(S0, S):
            logits, cache = lm.decode_step(params, cfg, cache, tokens[:, i], i)
            errs.append(max_err(logits[:, :V], ref[:, i]))
            pos_errs.append(row_errs(logits[:, :V], ref[:, i]))
            d_ok = d_ok and close(logits[:, :V], ref[:, i], 3e-2)
    row = dict(dtype=cfg.dtype, B=B, S0=S0, S=S, lose_state=lose_state,
               prefill_max_abs_err=err_p, prefill_ok=p_ok, decode_ok=d_ok,
               decode_max_abs_err=max(errs), decode_err_by_step=errs[::16],
               **quantiles("position_err", torch.cat(pos_errs)),
               logits_max_abs=float(ref.abs().max()), logits_std=float(ref.std()))
    print("  " + json.dumps({"consistency": row}), flush=True)
    return row


def kernels_vs_off(cfg, params, tokens) -> dict:
    """The kernel path against ``use_kernels="off"`` on one prefill: its
    last logits, the final SSM state of every layer, and the forward's
    logits at every position.  The control runs the kernel path with the
    state and conv window carried across chunk boundaries lost: the forward
    chunk by chunk, and the prefill of the last chunk alone."""
    import dataclasses

    from repro_torch.model import lm

    off = dataclasses.replace(cfg, use_kernels="off")
    V, S, Q = cfg.vocab_size, tokens.shape[1], cfg.ssm_chunk
    with torch.inference_mode():
        l_k, cache_k = lm.prefill(params, cfg, tokens=tokens)
        l_o, cache_o = lm.prefill(params, off, tokens=tokens)
        _, cache_c = lm.prefill(params, cfg, tokens=tokens[:, S - Q:])
    st_k, st_o, st_c = (c["pos0"]["state"] for c in (cache_k, cache_o, cache_c))
    f_o = full_logits(params, off, tokens)
    all_err = max_err(full_logits(params, cfg, tokens), f_o)
    ctrl_err = max_err(torch.cat([full_logits(params, cfg, tokens[:, i:i + Q])
                                  for i in range(0, S, Q)], 1), f_o)
    row = dict(dtype=cfg.dtype, B=tokens.shape[0], S=S,
               logits_max_abs_err=max(max_err(l_k[:, :V], l_o[:, :V]), all_err),
               last_logits_max_abs_err=max_err(l_k[:, :V], l_o[:, :V]),
               state_max_abs_err=max_err(st_k, st_o),
               control_logits_max_abs_err=ctrl_err,
               control_state_max_abs_err=max_err(st_c, st_o),
               logits_max_abs=float(f_o.abs().max()), logits_std=float(f_o.std()),
               state_max_abs=float(st_o.abs().max()))
    print("  " + json.dumps({"kernels_vs_off": row}), flush=True)
    return row


def engine_vs_isolated(cfg, params, held: bool = True) -> dict:
    """Continuous batching against isolated generation: a 4-slot engine with
    8 requests of 128-768 tokens, 32 new tokens each; every request's tokens
    equal its isolated generation, or first differ at a near tie (``held``;
    otherwise the first differences are only printed)."""
    from repro_torch.serving import Request, ServingEngine

    rng = np.random.default_rng(3)
    lens = [128, 256, 512, 768, 768, 512, 256, 128]
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab_size, n).astype(np.int32),
                    max_new=32) for i, n in enumerate(lens)]
    engine = ServingEngine(cfg, params, slots=4, max_len=1024, device="cuda")
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    check(len(done) == len(reqs), f"engine {cfg.name}: {len(done)} of {len(reqs)} requests done")
    same, ties = 0, []
    for r in sorted(done, key=lambda r: r.rid):
        want, gaps = isolated(cfg, params, r.prompt, r.max_new, 1024)
        if r.output == want:
            same += 1
            continue
        k = next((i for i, (a, b) in enumerate(zip(r.output, want)) if a != b),
                 min(len(r.output), len(want)))
        gap = gaps[k] if k < len(gaps) else float("inf")
        ties.append(dict(rid=r.rid, first_difference=k, top2_gap=gap))
        print(f"  engine request {r.rid}: first difference at token {k}, top-2 logit gap "
              f"{gap:.4g} (near-tie bound {NEAR_TIE})", flush=True)
        check(gap < NEAR_TIE or not held,
              f"engine {cfg.name} request {r.rid} differs from its isolated generation at "
              f"token {k} with a top-2 gap {gap:.3g} >= {NEAR_TIE}")
    serial = sum(len(r.output) - 1 for r in done)
    check(engine.steps < serial, f"engine {cfg.name}: {engine.steps} ticks, serial {serial}")
    eng = dict(arch=cfg.name, dtype=cfg.dtype, held=held, requests=len(reqs), slots=4,
               ticks=engine.steps,
               serial_ticks=serial, seconds=eng_s, equal_to_isolated=same, near_ties=ties,
               tokens_per_s=sum(len(r.output) for r in done) / eng_s)
    print("  " + json.dumps({"engine": eng}), flush=True)
    return eng


def phase_serve() -> dict:
    import dataclasses

    from repro_torch.launch.serve import run_serving
    from repro_torch.model import lm

    print("phase 7: LM serving, the main path", flush=True)
    # warm-up (first-call set-up of the libraries off the main run's clock)
    run_serving(SERVE["arch"], reduced=False, batch=SERVE["batch"], prompt_len=256,
                max_new=4, device="cuda", quiet=True)
    main = serve_main(SERVE["arch"], "main")
    cfg = get_cfg(SERVE["arch"])
    params = lm.init_model(cfg, 0, device="cuda")

    prof = profiled_decode(cfg, params)
    print("  " + json.dumps({"profiled_decode": prof}), flush=True)
    prefill_prof = profiled_prefill(cfg, params)
    print("  " + json.dumps({"profiled_prefill": prefill_prof}), flush=True)

    def tokens_of(seed: int, shape=(2, 768)) -> torch.Tensor:
        g = torch.Generator().manual_seed(seed)
        return torch.randint(3, cfg.vocab_size, shape, generator=g, dtype=torch.int32).cuda()

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = lm.init_model(cfg32, 0, device="cuda")
    seeds = BF16_SEEDS["decode"]
    consistency = {
        "float32": [decode_consistency(cfg32, params32, tokens_of(seeds[0]), S0=512)],
        "bfloat16": [decode_consistency(cfg, params, tokens_of(s), S0=512) for s in seeds],
        "bfloat16_control": [decode_consistency(cfg, params, tokens_of(s), S0=512,
                                                lose_state=True) for s in seeds],
    }
    for dt in ("float32", "bfloat16"):
        for row in consistency[dt]:
            check(row["prefill_ok"], f"serve {dt}: prefill logits not within 2e-2 of the "
                                     f"forward ({row['prefill_max_abs_err']:.3g})")
            ok = row["decode_ok"] if dt == "float32" else (
                row["decode_max_abs_err"] <= BF16_LOGITS_TOL)
            check(ok, f"serve {dt}: decode logits off the forward by "
                      f"{row['decode_max_abs_err']:.3g}")
    for row in consistency["bfloat16_control"]:
        ctrl = row["decode_max_abs_err"]
        check(ctrl > BF16_LOGITS_TOL, f"serve bfloat16: the lost-state control's decode is off "
                                      f"the forward by only {ctrl:.3g} <= {BF16_LOGITS_TOL}")

    # the kernel path against the plain path on the main path's prompt length
    # (one batch row): in float32 the two differ by summation order only; in
    # bf16 the plain path also rounds the chunk weights to bf16 (the
    # reference's w.astype(x.dtype)).  That rounding moves the bf16 final
    # states as far as the control does, so in bf16 the states are held
    # through the decode that reads them (above) and only printed here.
    kvo_seeds = BF16_SEEDS["kernels_vs_off"]
    kvo = {"float32": [], "bfloat16": []}
    for dtype, c, p, tol, held, run_seeds in (
        ("float32", cfg32, params32, 1e-3, ("logits", "state"), kvo_seeds[:1]),
        ("bfloat16", cfg, params, BF16_LOGITS_TOL, ("logits",), kvo_seeds),
    ):
        for seed in run_seeds:
            row = kernels_vs_off(c, p, tokens_of(seed, (1, SERVE["prompt_len"])))
            kvo[dtype].append(row)
            for what in held:
                err, ctrl = row[f"{what}_max_abs_err"], row[f"control_{what}_max_abs_err"]
                check(err <= tol, f"serve {dtype}: kernel path's {what} off use_kernels='off' "
                                  f"by {err:.3g} > {tol}")
                check(ctrl > tol, f"serve {dtype}: the lost-carry control's {what} off "
                                  f"use_kernels='off' by only {ctrl:.3g} <= {tol}")
    del params32

    eng = engine_vs_isolated(cfg, params)
    del params

    smollm = serve_main("smollm-135m", "smollm")
    smollm_flash = flash_prefill("smollm-135m")
    return dict(main, profiled_decode=prof, profiled_prefill=prefill_prof,
                consistency=consistency, kernels_vs_off=kvo, engine=eng, smollm=smollm,
                smollm_flash_prefill=smollm_flash)


# ---------------------------------------------------------------------------
# Phase 8: the grouped-matmul kernel against its plain version
# ---------------------------------------------------------------------------

GMM_SHAPES = {
    # name: (E, C, d, f, dtype)
    "prefill": (64, 1984, 2048, 1408, torch.bfloat16),  # gate / up: 8 rows x C=248
    "down": (64, 1984, 1408, 2048, torch.bfloat16),
    "decode8": (64, 8, 2048, 1408, torch.bfloat16),  # a decode step of 8 sequences
    "decode6": (64, 6, 2048, 1408, torch.bfloat16),  # one sequence decoded alone
    "f32": (64, 248, 2048, 1408, torch.float32),  # one 2048-token prompt, float32
}
GMM_TOL = {torch.bfloat16: 3e-2, torch.float32: 3e-4}  # tests/test_kernels.py:116


def gmm_work(E, C, d, f, dtype) -> dict:
    esz = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(2 * E * C * d * f, esz * (E * C * d + E * d * f + E * C * f), peak)


# a row's result against C: the path's (8, 6, 248, 1984), either side of the
# tile plan's one switch (64 / 65 rows: one warpgroup a block, or two), and a
# lone row
GMM_SAME_ROWS_C = (1, 6, 8, 40, 64, 65, 128, 248, 1984)


def same_rows(gmm, x, w, got, g) -> None:
    """Every row summed in one order whatever C and the tile plan: the decode
    rows ``x`` (C = 8, result ``got``) followed by more rows, launched at each
    C of ``GMM_SAME_ROWS_C``, and one row moved to the top of its tile."""
    E, C, d = x.shape
    more = torch.randn(E, max(GMM_SAME_ROWS_C) - C, d, generator=g, device="cuda").to(x.dtype)
    rows = torch.cat([x, more], 1)
    full = gmm.grouped_matmul_cuda(rows, w)
    same = {"moved row": torch.equal(gmm.grouped_matmul_cuda(x[:, 5:6].contiguous(), w),
                                     got[:, 5:6]),
            "C=8 in C=1984": torch.equal(full[:, :C], got)}
    for c in GMM_SAME_ROWS_C:
        same[f"C={c} wgs={gmm.tile_plan(c)}"] = torch.equal(
            gmm.grouped_matmul_cuda(rows[:, :c].contiguous(), w), full[:, :c])
    print(f"  moe_gmm rows bitwise equal across C and warpgroups a block: {same}", flush=True)
    check(all(same.values()), f"moe_gmm: a row's result depends on C or its tile ({same})")


def phase_gmm() -> dict:
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.moe_gmm.ref import grouped_matmul_ref

    print("phase 8: grouped-matmul kernel against its plain version on the card", flush=True)
    gmm.LIBRARY.build()
    check_ptxas(gmm.LIBRARY.log, "gmm_wgmma_kernel", lambda fn: True)
    rows = {}
    for seed, (shape, (E, C, d, f, dtype)) in enumerate(GMM_SHAPES.items()):
        g = torch.Generator(device="cuda").manual_seed(300 + seed)
        x = torch.randn(E, C, d, generator=g, device="cuda").to(dtype)
        w = (torch.randn(E, d, f, generator=g, device="cuda") * 0.05).to(dtype)
        got, want = gmm.grouped_matmul_cuda(x, w), grouped_matmul_ref(x, w)
        torch.cuda.synchronize()
        tol = GMM_TOL[dtype]
        check(close(got, want, tol), f"moe_gmm {shape}: kernel not within {tol} of plain "
                                     f"(max abs err {max_err(got, want):.3g})")
        check(bool(torch.isfinite(got).all()), f"moe_gmm {shape}: non-finite kernel output")
        if shape == "decode8":
            same_rows(gmm, x, w, got, g)

        def kern():
            return gmm.grouped_matmul_cuda(x, w)

        def plain():
            return grouped_matmul_ref(x, w)

        def lib():  # the library yardstick, never called by the port
            return torch.bmm(x, w)

        row = dict(
            shape=shape, kernel="moe_gmm", E=E, C=C, d=d, f=f, dtype=str(dtype),
            max_abs_err=max_err(got, want), max_abs_y=float(want.float().abs().max()),
            ms=device_ms(kern, reps_for(kern)), plain_ms=device_ms(plain, reps_for(plain)),
            library_ms=device_ms(lib, reps_for(lib)), **gmm_work(E, C, d, f, dtype),
        )
        rows[shape] = row
        print("  " + json.dumps(row), flush=True)
        del x, w, got, want
    return rows


# ---------------------------------------------------------------------------
# Phase 9: MoE serving, this slice's main path
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-moe-16b"  # served at SERVE's batch, prompt length and new tokens
# float32 at 28 layers would take 67.5 GB of weights; the float32 checks run
# the published widths at this depth
MOE_F32_LAYERS = 4
# bf16 at full width: the forward and the step-by-step decode (and the kernel
# and plain expert products) round at other points, and a token whose k-th
# and (k+1)-th router logits are within that rounding takes other experts, a
# jump of up to about 1 in its logits.  So the bf16 checks hold the median
# position (one error per position: max |logit difference| over the
# vocabulary), which the few re-routed positions do not move, and print the
# 90th percentile and the largest.  The limit lies between the sound runs'
# medians (0.19-0.21 on an H100 80GB HBM3) and their controls' (the prompt's
# keys and values lost before decode: 5.7; the first layer's routed experts
# lost: 1.5); the run fails if a control does not exceed it.  Float32, where
# only summation order differs and re-routing needs a near-tie at 1e-6, is
# held to the reference's tolerances.
MOE_BF16_LOGITS_TOL = 0.5
MOE_SEEDS = {"decode": (31, 32, 33), "kernels_vs_off": (41, 42, 43)}
# the lost-experts controls: (held against the limit, printed beside it)
MOE_CONTROL_LAYERS = {"float32": ((0, MOE_F32_LAYERS - 1), ()), "bfloat16": ((0,), (27,))}


def no_drop(cfg):
    """The config with a capacity no assignment can overflow (C >= tokens),
    so that the full forward and prefill + decode route the same way."""
    import dataclasses

    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def moe_kernels_vs_off(cfg, params, tokens, control_layers) -> dict:
    """The kernel path against ``use_kernels="off"`` on one prefill: the
    forward's logits at every position, one error per position.  Each
    control runs the kernel path with the routed experts of one layer lost
    (its down projection zeroed, then restored)."""
    import dataclasses

    from repro_torch.model import lm

    off = dataclasses.replace(cfg, use_kernels="off")
    V = cfg.vocab_size
    with torch.inference_mode():
        l_k, _ = lm.prefill(params, cfg, tokens=tokens)
        l_o, _ = lm.prefill(params, off, tokens=tokens)
    f_o = full_logits(params, off, tokens)
    row = dict(dtype=cfg.dtype, layers=cfg.num_layers, B=tokens.shape[0], S=tokens.shape[1],
               last_logits_max_abs_err=max_err(l_k[:, :V], l_o[:, :V]),
               **quantiles("position_err", row_errs(full_logits(params, cfg, tokens), f_o)))
    w_down = params["layers"]["pos0"]["ffn"]["w_down"]
    for layer in control_layers:
        with torch.no_grad():
            saved = w_down[layer].clone()
            w_down[layer].zero_()
            ctrl = row_errs(full_logits(params, cfg, tokens), f_o)
            w_down[layer].copy_(saved)
        row.update(quantiles(f"control{layer}_position_err", ctrl))
    row.update(logits_max_abs=float(f_o.abs().max()), logits_std=float(f_o.std()))
    print("  " + json.dumps({"kernels_vs_off": row}), flush=True)
    return row


def phase_moe_serve() -> dict:
    import dataclasses

    from repro_torch.launch.serve import run_serving
    from repro_torch.model import lm
    from repro_torch.pytree import tree_leaves

    print("phase 9: MoE serving, the main path", flush=True)
    run_serving(MOE_ARCH, reduced=False, batch=SERVE["batch"], prompt_len=256, max_new=4,
                device="cuda", quiet=True)  # warm-up
    print(f"  allocated before the main run: {torch.cuda.memory_allocated() / 1e9:.3f} GB",
          flush=True)
    main = serve_main(MOE_ARCH, "moe")
    cfg = get_cfg(MOE_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  init_model: {n_params} parameters in {init_s:.3f}s, "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated", flush=True)

    prof = profiled_decode(cfg, params, match=("gmm_wgmma_kernel",))
    print("  " + json.dumps({"profiled_decode": prof}), flush=True)
    gmm_step = prof["matched"]["gmm_wgmma_kernel"]
    print(f"  moe_gmm per decode step: {gmm_step['ms_per_call']:.3f} ms in "
          f"{gmm_step['launches_per_call']:.0f} launches, of {prof['device_busy_ms_per_call']:.3f} "
          f"ms device busy; prefill {main['prefill_tokens_per_s']:.1f} tokens/s, decode "
          f"{main['decode_tokens_per_s']:.2f} tokens/s", flush=True)
    check(gmm_step["launches_per_call"] == GMM_PER_FORWARD[MOE_ARCH],
          f"moe: {gmm_step['launches_per_call']} moe_gmm launches per profiled decode step")
    # the attention decode reads the bf16 K/V cache as it lies: no copy or
    # cast of a layer's cache, which could not take less than reading it once
    cache_read_us = (SERVE["batch"] * prof["cache_len"] * cfg.num_kv_heads
                     * cfg.head_dim * 2 / HBM_BYTES_PER_S * 1e6)
    print(f"  longest copy or elementwise kernel per launch {prof['longest_copy_us']:.2f} us; "
          f"reading one layer's K cache takes at least {cache_read_us:.2f} us", flush=True)
    check(prof["longest_copy_us"] < cache_read_us,
          "moe: a copy or cast kernel in the decode step is as long as a K/V cache copy")
    # the two products of each layer's decode, at this window's cache, then a
    # sweep of head counts and cache lengths for where their design loses
    products = decode_products(SERVE["batch"], cfg.head_dim,
                               ((cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                                 prof["cache_len"]),) + DECODE_PRODUCT_SWEEP)
    here = products[0]
    print(f"  decode products per step ({cfg.num_layers} layers): "
          f"{here['ms'] * cfg.num_layers:.3f} ms (one bmm per kv head "
          f"{here['per_head_ms'] * cfg.num_layers:.3f}, float32 casts "
          f"{here['plain_ms'] * cfg.num_layers:.3f}, reading K and V once "
          f"{here['bound_ms'] * cfg.num_layers:.3f})", flush=True)

    def tokens_of(seed: int, shape=(2, 768)) -> torch.Tensor:
        g = torch.Generator().manual_seed(seed)
        return torch.randint(3, cfg.vocab_size, shape, generator=g, dtype=torch.int32).cuda()

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                                num_layers=MOE_F32_LAYERS)
    params32 = lm.init_model(cfg32, 0, device="cuda")
    seeds = MOE_SEEDS["decode"]
    nd = no_drop(cfg)
    consistency = {
        "float32": [decode_consistency(no_drop(cfg32), params32, tokens_of(seeds[0]), S0=512)],
        "bfloat16": [decode_consistency(nd, params, tokens_of(s), S0=512) for s in seeds],
        "bfloat16_control": [decode_consistency(nd, params, tokens_of(seeds[0]), S0=512,
                                                lose_state=True)],
    }
    for row in consistency["float32"]:
        check(row["prefill_ok"] and row["decode_ok"],
              f"moe float32: prefill / decode logits off the forward by "
              f"{row['prefill_max_abs_err']:.3g} / {row['decode_max_abs_err']:.3g}")
    for row in consistency["bfloat16"]:
        err = row["position_err_p50"]
        check(err <= MOE_BF16_LOGITS_TOL, f"moe bfloat16: the median position's decode logits "
                                          f"off the forward by {err:.3g}")
    for row in consistency["bfloat16_control"]:
        ctrl = row["position_err_p50"]
        check(ctrl > MOE_BF16_LOGITS_TOL, f"moe bfloat16: the lost-cache control's median "
                                          f"position off the forward by only {ctrl:.3g} <= "
                                          f"{MOE_BF16_LOGITS_TOL}")

    kvo = {"float32": [], "bfloat16": []}
    for dtype, c, p, tol, run_seeds in (
        ("float32", cfg32, params32, 1e-3, MOE_SEEDS["kernels_vs_off"][:1]),
        ("bfloat16", cfg, params, MOE_BF16_LOGITS_TOL, MOE_SEEDS["kernels_vs_off"]),
    ):
        held, shown = MOE_CONTROL_LAYERS[dtype]
        for seed in run_seeds:
            row = moe_kernels_vs_off(c, p, tokens_of(seed, (1, SERVE["prompt_len"])),
                                     held + shown)
            kvo[dtype].append(row)
            err = row["position_err_p50"]
            check(err <= tol, f"moe {dtype}: the median position's logits off "
                              f"use_kernels='off' by {err:.3g} > {tol}")
            for layer in held:
                ctrl = row[f"control{layer}_position_err_p50"]
                check(ctrl > tol, f"moe {dtype}: the lost-experts control (layer {layer}) off "
                                  f"use_kernels='off' by only {ctrl:.3g} <= {tol}")

    # the engine against isolated generation: held in float32; in bf16 a
    # batch of 4 and a lone request round differently, and a re-routed token
    # moves the logits by more than NEAR_TIE allows for, so there the first
    # differences are printed
    eng32 = engine_vs_isolated(cfg32, params32)
    del params32
    eng = engine_vs_isolated(cfg, params, held=False)
    del params
    return dict(main, init_seconds=init_s, parameters=n_params, profiled_decode=prof,
                decode_products=products, consistency=consistency, kernels_vs_off=kvo,
                engine=eng, engine_float32=eng32)


# ---------------------------------------------------------------------------
# Phase 10: the int8 quantization kernel against its plain version
# ---------------------------------------------------------------------------

QUANT_SHAPES = {
    # name: (R, d, dtype).  smollm-135m's 11 gradient leaves as the
    # compression path's _roundtrip makes them rows (float32: g + error)
    "embed": (49152, 576, torch.float32),
    "w_down": (46080, 576, torch.float32),  # (30, 1536, 576)
    "w_gate_up": (17280, 1536, torch.float32),  # (30, 576, 1536), twice
    "wq_wo": (17280, 576, torch.float32),
    "wk_wv": (17280, 192, torch.float32),
    "norms": (30, 576, torch.float32),
    "final_norm": (1, 576, torch.float32),
    # llama3-8b leaves: the untied head, the stacked w_gate (1.88e9
    # elements), the stacked wq / wo
    "llama_head": (4096, 128256, torch.float32),
    "llama_w_gate_bf16": (131072, 14336, torch.bfloat16),
    "llama_wq": (131072, 4096, torch.float32),
    "row_2e20": (1, 2 ** 20, torch.float32),  # one wide row, as a 1-D leaf arrives
}
QUANT_TIES = (127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5)  # scale 1: half-way ties
BIG = 2 ** 28  # elements: time the plain version with events (its float32
# temporaries of several GB are not worth capturing in a graph) and take
# fewer kernel replays


def quant_inputs(R: int, d: int, dtype, seed: int) -> torch.Tensor:
    """Seeded normal rows on the card; with six rows or more, the first six
    hold a NaN, +inf, -inf, all zeros, all -0.0 and half-way ties."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(R, d, generator=g, device="cuda") * 3).to(dtype)
    if R >= 6:
        x[0, d // 2] = float("nan")
        x[1, 3 % d] = float("inf")
        x[2, 7 % d] = float("-inf")
        x[3] = 0.0
        x[4] = -0.0
        ties = torch.tensor(QUANT_TIES, device="cuda", dtype=dtype)
        x[5] = ties.repeat(-(-d // len(QUANT_TIES)))[:d]
    return x


def quant_work(R: int, d: int, dtype) -> dict:
    """Bytes: x read once, q and the scales written once; operations: abs,
    max, the division, round and a two-sided clamp per element."""
    esz = torch.finfo(dtype).bits // 8
    return bound(6 * R * d, R * d * esz + R * d + 4 * R)


def phase_quant() -> dict:
    from repro_torch.kernels.quant import kernel as quant
    from repro_torch.kernels.quant.ref import quantize_int8_ref

    print("phase 10: int8 quantization kernel against its plain version on the card",
          flush=True)
    rows = {}
    for seed, (shape, (R, d, dtype)) in enumerate(QUANT_SHAPES.items()):
        x = quant_inputs(R, d, dtype, 500 + seed)
        q_k, s_k = quant.quantize_int8_cuda(x)
        q_p, s_p = quantize_int8_ref(x)
        torch.cuda.synchronize()
        same_q = bool(torch.equal(q_k, q_p))
        same_s, _ = compare(s_k, s_p)
        check(same_q and same_s, f"quant {shape}: kernel != plain version bitwise "
                                 f"(q {same_q}, scale {same_s})")
        if R >= 6:
            special = bool((q_k[:5] == 0).all()) and bool(torch.isnan(s_k[0]).all()) and bool(
                torch.isinf(s_k[1:3]).all())
            check(special, f"quant {shape}: NaN / inf / zero rows not all-zero codes with a "
                           f"NaN / inf scale")
            check(q_k[5, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -4],
                  f"quant {shape}: half-way ties not rounded to even ({q_k[5, :8].tolist()})")
        big = R * d >= BIG

        def kern():
            return quant.quantize_int8_cuda(x)

        def plain():
            return quantize_int8_ref(x)

        ms = device_ms(kern, reps_for(kern, most=10 if big else 200))
        plain_ms = call_ms(plain, 3) if big else device_ms(plain, reps_for(plain, most=50))
        fin = torch.isfinite(s_p)
        row = dict(
            shape=shape, kernel="quantize_int8", R=R, d=d, dtype=str(dtype),
            bitwise=same_q and same_s,
            max_abs_err=max(max_err(s_k[fin], s_p[fin]), max_err(q_k, q_p)), ms=ms,
            plain_ms=plain_ms, plain_timing="events" if big else "graph",
            library_ms=None, **quant_work(R, d, dtype),
        )
        rows[shape] = row
        print("  " + json.dumps(row), flush=True)
        del x, q_k, s_k, q_p, s_p
    return rows


# ---------------------------------------------------------------------------
# Phase 11: int8 error-feedback compression, this slice's main path
# ---------------------------------------------------------------------------

COMPRESS = dict(arch="smollm-135m", batch=8, seq_len=2048, rounds=20)
EF_REL_TOL = 0.01  # tests/test_checkpoint_fault.py::test_ef_compression_error_feedback


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits (so NaN == NaN and -0.0 != +0.0)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype:
        return False
    if a.dtype not in ints:  # integers and booleans: equal values are equal bits
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def phase_compress() -> dict:
    import os

    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed.compression import (
        all_reduce_int8,
        ef_compress_grads,
        init_ef_state,
    )
    from repro_torch.kernels.quant import dequantize_int8, quantize_int8
    from repro_torch.kernels.quant import kernel as quant
    from repro_torch.model import lm
    from repro_torch.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

    print("phase 11: int8 error-feedback compression, the main path", flush=True)
    cfg = get_cfg(COMPRESS["arch"])  # use_kernels="cuda"
    params = lm.init_model(cfg, 0, device="cuda")
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=COMPRESS["seq_len"],
        global_batch=COMPRESS["batch"], seed=0,
    )).next_batch()
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    leaves, treedef = tree_flatten(params)
    zero_lm_counts()
    t0 = time.perf_counter()
    loss, _ = lm.lm_loss(params, cfg, batch)
    grads = tree_unflatten(treedef, [g.detach() for g in torch.autograd.grad(loss, leaves)])
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = {k: v for k, v in lm_counts().items() if k not in ("ssd_scan", "moe_gmm")}
    g_leaves = tree_leaves(grads)
    n_leaves = len(g_leaves)
    print(f"  gradient tree: loss {float(loss.detach()):.4f}, {n_leaves} leaves, "
          f"{sum(g.numel() for g in g_leaves)} elements, dtypes "
          f"{sorted({str(g.dtype) for g in g_leaves})}, {grad_s:.3f}s, launches "
          f"{grad_launches}", flush=True)
    del params, leaves, loss
    check(all(bool(torch.isfinite(g).all()) for g in g_leaves), "compress: non-finite grads")
    for name, n in grad_launches.items():
        check(n > 0, f"compress: {name} was never launched for the grads")

    ef_k, ef_o = init_ef_state(grads), init_ef_state(grads)
    total = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device="cuda"), grads)
    rounds = COMPRESS["rounds"]
    round_s, mismatched = [], []
    quant.LAUNCHES = 0  # the count covers the main path's rounds only
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cg_k, ef_k = ef_compress_grads(grads, ef_k, use_kernels="cuda")
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        cg_o, ef_o = ef_compress_grads(grads, ef_o, use_kernels="off")
        for what, a, b in (("grads", cg_k, cg_o), ("error", ef_k, ef_o)):
            for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
                if not bits_equal(x, y):
                    mismatched.append((r, what, i))
        for t, c in zip(tree_leaves(total), tree_leaves(cg_k)):
            t += c.float()
    torch.cuda.synchronize()
    launches = quant.LAUNCHES
    num = sum(float(((t - rounds * g.float()).double() ** 2).sum())
              for t, g in zip(tree_leaves(total), g_leaves))
    den = sum(float(((rounds * g.float()).double() ** 2).sum()) for g in g_leaves)
    rel = math.sqrt(num / den)
    steady = sorted(round_s[1:])
    round_ms = steady[len(steady) // 2] * 1e3
    check(launches == n_leaves * rounds,
          f"compress: {launches} quantize_int8 launches in {rounds} rounds, expected "
          f"{n_leaves * rounds}")
    check(not mismatched, f"compress: kernel path != use_kernels='off' bitwise at (round, "
                          f"what, leaf) {mismatched[:8]}")
    check(rel < EF_REL_TOL, f"compress: error feedback's relative error {rel:.3g} >= "
                            f"{EF_REL_TOL}")

    # profiled windows of 3 rounds: the kernel's share of a round, the idle
    # share; once after a traced warm-up round that the profiler's schedule
    # discards, as every profiled phase does, and once without it, to show
    # what that loses (device records against what the host enqueued)
    def one_round():
        ef_compress_grads(grads, ef_k, use_kernels="cuda")

    plain_window = profile_window(one_round, 3, warmup=False, match=("quant_kernel",))
    prof_row = profile_window(one_round, 3, match=("quant_kernel",))
    check_window(prof_row, "compress: profiled window")
    prof_row["without_warmup"] = {k: v for k, v in plain_window.items() if k != "top_kernels"}

    # all_reduce_int8 over a one-rank NCCL group: the round trip, one launch
    x = grads["embed"]["tok"]
    allreduce = dict(ok=False, launches=None)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        try:
            torch.cuda.set_device(0)
            dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
        except Exception as e:  # noqa: BLE001 — reported, fails the run
            check(False, f"compress: NCCL could not start a one-rank group: {e!r}")
        else:
            try:
                before = quant.LAUNCHES
                got = all_reduce_int8(x)
                torch.cuda.synchronize()
                allreduce["launches"] = quant.LAUNCHES - before
                want = dequantize_int8(*quantize_int8(x)).to(x.dtype)
                allreduce["ok"] = bits_equal(got, want)
            finally:
                dist.destroy_process_group()
    check(allreduce["ok"], "compress: all_reduce_int8 over one NCCL rank != the round trip")
    check(allreduce["launches"] == 1,
          f"compress: all_reduce_int8 made {allreduce['launches']} launches, expected 1")

    row = dict(
        arch=COMPRESS["arch"], batch=COMPRESS["batch"], seq_len=COMPRESS["seq_len"],
        leaves=n_leaves, elements=sum(g.numel() for g in g_leaves), grad_seconds=grad_s,
        rounds=rounds, launches=launches, launches_per_round=launches / rounds,
        round_ms_median=round_ms, round_ms=[s * 1e3 for s in round_s],
        ef_relative_error=rel, kernel_equals_off=not mismatched, profiled=prof_row,
        all_reduce=allreduce,
    )
    print("  " + json.dumps(row), flush=True)
    return row


# ---------------------------------------------------------------------------
# Phase 12: the profile-guided partitioner (profile, MILP, explore)
# ---------------------------------------------------------------------------

# ``benchmarks/table2_dse.py``'s sizes, block and link sweep
DSE_SIZES = {"TopFilter": 20000, "FIR32": 4000, "Bitonic8": 800, "IDCT8": 800, "ZigZag": 100}
DSE_BLOCK = 2048
DSE_BANDWIDTH = (256, 1024, 4096)


def timed_run(prog, got):
    """One ``run()``: outputs, report, launches of the stream kernel, and the
    programs it compiled (each must end before the run's clock began)."""
    from repro_torch.kernels.stream_fused import kernel

    launches, built = kernel.LAUNCHES, len(kernel.BUILDS)
    rep = prog.run()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    builds = [dict(library=lib, seconds=t1 - t0, before_run_s=t_end - rep.seconds - t1)
              for t0, t1, lib in kernel.BUILDS[built:]]
    return list(got), rep, kernel.LAUNCHES - launches, builds


def fused_regions(prog) -> int:
    """Fused stream regions (one generated kernel each) in a placement."""
    return sum(1 for a in prog.module.actors.values() if a.is_fused and a.codegen == "cuda")


def pinned_idct8_profile(graph):
    """IDCT8's profile with the device far cheaper than the host, so the
    MILP's 2-partition point holds all three device actors whatever the
    host's load (the CPU tests pin the same profile)."""
    from repro_torch.core.cost_model import NetworkProfile

    prof = NetworkProfile()
    for a, actor in graph.actors.items():
        prof.exec_sw[a] = 1e-2
        if actor.device_ok:
            prof.exec_hw[a] = 1e-5
    for ch in graph.channels:
        prof.tokens[ch.key] = 128
        prof.buffers[ch.key] = 4096
    prof.n_cores = 4
    return prof


def runnable(graph, point) -> bool:
    """No hw partition of ``point`` feeds itself through actors off it (the
    port refuses such a placement: it would stall PLink)."""
    from repro_torch.runtime.device_runtime import feeds_itself

    asg = point.solution.assignment
    return not any(feeds_itself(graph.channels, [a for a, p in asg.items() if p == pid])
                   for pid in point.accel_ids)


C8_ACTORS = 3  # single-actor partitions measured per network (the first device actors)
C8_REPS = 200


def unfused_step(nets) -> dict:
    """ROADMAP C8: single-actor partitions as ``core/profiler.py::
    profile_device`` builds them (``compile_partition(graph, [actor])``: the
    legacy, unfused lowering, per-actor torch ops) at phase 12's block, on
    seeded inputs: the eager step's device kernels and device busy µs a call
    (the profiler's) and its host µs a call (``C8_REPS`` calls, then one
    synchronise), beside the same step as ``profile_device`` now runs it,
    captured once after a warm-up by ``core/profiler.py::capture_step`` and
    replayed, timed the same way.  The replay's outputs,
    idle flag and state equal the eager step's bitwise, and on the
    compare-only networks the CPU's eager step's too."""
    import repro_torch
    from repro_torch.core.graph import GraphError
    from repro_torch.core.profiler import capture_step
    from repro_torch.runtime.device_runtime import compile_partition

    dev = torch.device("cuda:0")

    def host_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(C8_REPS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / C8_REPS * 1e6

    def leaves(out):
        state, outs, idle = out
        return [idle] + [t for pair in outs.values() for t in pair] + [
            t for st in state.values() for t in st.values() if isinstance(t, torch.Tensor)]

    rows = []
    for name, size in DSE_SIZES.items():
        net, _got = build_net(nets, name, size)
        graph = repro_torch.compile(net, block=DSE_BLOCK).graph
        taken = 0
        for actor, spec in graph.actors.items():
            if taken == C8_ACTORS or not spec.device_ok:
                continue
            try:
                program = compile_partition(graph, [actor], block=DSE_BLOCK, device=dev)
            except (AssertionError, GraphError):
                continue
            taken += 1
            gen = torch.Generator(device=dev).manual_seed(taken)
            ins = {f"{a}.{p}": (torch.randn(DSE_BLOCK, generator=gen, device=dev),
                                torch.ones(DSE_BLOCK, dtype=torch.bool, device=dev))
                   for (a, p, _dt) in program.in_ports}
            state = program.init_state

            def eager(program=program, state=state, ins=ins):
                return program.step(state, ins)

            prof = profile_window(eager, 5)
            row = dict(network=name, actor=actor, stateful=any(bool(v) for v in state.values()),
                       kernels_per_call=prof["records"] / prof["calls"],
                       device_busy_us=prof["device_busy_ms_per_call"] * 1e3,
                       eager_host_us=host_us(eager))
            cuda_graph, replay = capture_step(program.step, state, ins, dev)
            cuda_graph.replay()
            torch.cuda.synchronize()
            same = all(bits_equal(a, b) for a, b in zip(leaves(replay), leaves(eager())))
            if name in EXACT:
                cpu = compile_partition(graph, [actor], block=DSE_BLOCK, device="cpu")
                on_cpu = cpu.step(cpu.init_state,
                                  {k: (v.cpu(), m.cpu()) for k, (v, m) in ins.items()})
                same = same and all(bits_equal(a.cpu(), b)
                                    for a, b in zip(leaves(replay), leaves(on_cpu)))
            row.update(graph_host_us=host_us(cuda_graph.replay), graph_bitwise=same)
            row["speedup"] = row["eager_host_us"] / row["graph_host_us"]
            rows.append(row)
            print("  C8 " + json.dumps(row), flush=True)
            check(same, f"C8 {name}.{actor}: the CUDA graph's step != the eager step")
    ratios = sorted(r["speedup"] for r in rows)
    check(bool(rows), "C8: no unfused step measured")
    summary = dict(partitions=len(rows), median_speedup=ratios[len(ratios) // 2],
                   min_speedup=ratios[0], eager_host_us=sorted(r["eager_host_us"] for r in rows),
                   graph_host_us=sorted(r["graph_host_us"] for r in rows))
    print("  C8 summary: " + json.dumps(summary), flush=True)
    return dict(rows=rows, summary=summary)


def phase_explore(nets, card: str) -> dict:
    import repro_torch
    from repro_torch.core.cost_model import evaluate
    from repro_torch.core.partitioner import best_point
    from repro_torch.core.profiler import measure_device_link
    from repro_torch.frontend.dsl import FrontendError
    from repro_torch.frontend.program import synthesize_xcf

    from repro_torch.kernels.stream_fused import kernel

    print("phase 12: the profile-guided partitioner (profile, MILP, explore)", flush=True)
    c8 = unfused_step(nets)
    kernel.LAUNCHES = 0  # the count covers this phase's runs only
    rows, launches = {}, {}
    for name, size in DSE_SIZES.items():
        net, got = build_net(nets, name, size)
        prog = repro_torch.compile(net, block=DSE_BLOCK)
        t0 = time.perf_counter()
        prof = prog.profile(block=DSE_BLOCK, bandwidth_sizes=DSE_BANDWIDTH)
        profile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        points = prog.explore(prof, thread_counts=(1, 2, 3), accel_options=(False, True))
        explore_s = time.perf_counter() - t0
        check(bool(points), f"explore {name}: no design points")
        for p in points:
            print(f"  {name}: threads {p.n_threads} accel {p.n_accels}: predicted "
                  f"{p.predicted:.6g} s, hw actors {p.hw_actors()}"
                  f"{'' if runnable(prog.graph, p) else ' (feeds itself through the host)'}",
                  flush=True)
        stalls = [p for p in points if not runnable(prog.graph, p)]
        points = [p for p in points if runnable(prog.graph, p)]
        for p in stalls:
            try:
                prog.repartition(xcf=p.xcf)
                refused = False
            except FrontendError:
                refused = True
            check(refused, f"explore {name}: a self-feeding placement compiled")
        dev_points = [p for p in points if p.hw_actors()]
        if not dev_points:
            print(f"  {name}: every design point that uses the device feeds itself through "
                  f"the host; the all-device corner runs in its place", flush=True)
        host, _rep, _n, _b = timed_run(prog.repartition(backend="host"), got)
        row = dict(network=name, size=size, profile_s=profile_s, explore_s=explore_s,
                   points=len(points) + len(stalls), feeding_itself=len(stalls),
                   exec_hw={a: prof.exec_hw[a] for a in sorted(prof.exec_hw)},
                   exec_sw_total=sum(prof.exec_sw.values()))
        # the MILP's best point, its best point on the device, and the
        # all-device corner priced by the same cost model
        corner = synthesize_xcf(prog.graph, "device")
        best = [("best", best_point(points))]
        best += [("best_device", best_point(dev_points))] if dev_points else []
        runs = [(tag, p.xcf, p.predicted, p.n_threads, p.hw_actors()) for tag, p in best]
        runs.append(("all_device", corner,
                     evaluate(prog.graph, corner.assignment(), prof)["T_exec"], 1,
                     sorted(a for a, pid in corner.assignment().items() if pid == "accel")))
        for tag, xcf, predicted, threads, hw in runs:
            placed = prog.repartition(xcf=xcf)
            out, rep, n, builds = timed_run(placed, got)
            regions = fused_regions(placed)
            row[tag] = dict(threads=threads, hw_actors=hw, predicted_s=predicted,
                            measured_s=rep.seconds, plink_launches=rep.plink_launches,
                            kernel_launches=n, fused_regions=regions, builds=builds)
            print(f"  {name} {tag}: predicted {predicted:.6g} s, measured {rep.seconds:.6g} s, "
                  f"{n} stream-kernel launches, {regions} fused regions, "
                  f"{len(builds)} programs compiled before the run "
                  f"({sum(b['seconds'] for b in builds):.2f} s)", flush=True)
            check((n > 0) == (regions > 0),
                  f"explore {name} {tag}: {n} stream-kernel launches for {regions} fused regions")
            for b in builds:
                check(b["before_run_s"] >= 0,
                      f"explore {name} {tag}: kernel {b['library']} compiled inside the run")
            check(len(out) == len(host) > 0,
                  f"explore {name} {tag}: {len(out)} outputs vs {len(host)} on the host")
            if name in EXACT:
                check(out == host, f"explore {name} {tag}: != host bitwise")
            else:
                check(np.allclose(out, host, rtol=1e-5, atol=1e-4),
                      f"explore {name} {tag}: not allclose to the host")
            if tag == "all_device" and name in FUSED_NETS:
                check(n > 0, f"explore {name}: the all-device corner never launched the kernel")
            if name in FUSED_NETS:
                launches[name] = launches.get(name, 0) + n
        rows[name] = row

    # IDCT8 over 0, 1 and 2 accelerator partitions of at most 2 actors: the
    # live profile's 2-partition point and a pinned profile's, each run on
    # the card against the 1-partition placement, bitwise
    net, got = build_net(nets, "IDCT8", DSE_SIZES["IDCT8"])
    prog = repro_torch.compile(net, block=DSE_BLOCK)
    one, _rep, _n, _b = timed_run(prog.repartition(backend="device"), got)
    kw = dict(thread_counts=(1,), accel_options=(0, 1, 2), accel_capacity=2)
    multi = {}
    for tag, prof in (("live", prog.profile(block=DSE_BLOCK, include_links=False)),
                      ("pinned", pinned_idct8_profile(prog.graph))):
        points = {p.n_accels: p for p in prog.explore(prof, **kw)}
        check(set(points) == {0, 1, 2}, f"explore IDCT8 {tag}: accel counts {sorted(points)}")
        if 2 not in points or not runnable(prog.graph, points[2]):
            print(f"  IDCT8 accel_capacity=2 ({tag} profile): no runnable 2-accel point",
                  flush=True)
            check(tag == "live", "explore IDCT8 pinned: the 2-accel point feeds itself")
            continue
        placed = prog.repartition(xcf=points[2].xcf)
        out, rep, n, _b = timed_run(placed, got)
        asg = points[2].solution.assignment
        multi[tag] = dict(partitions={pid: sorted(a for a, q in asg.items() if q == pid)
                                      for pid in placed.hw_partitions},
                          predicted_s=points[2].predicted, measured_s=rep.seconds,
                          kernel_launches=n)
        print(f"  IDCT8 accel_capacity=2 ({tag} profile): {multi[tag]['partitions']}, "
              f"{rep}, {n} stream-kernel launches", flush=True)
        check(out == one, f"explore IDCT8 {tag}: the 2-accel point != 1 partition bitwise")
        check((n > 0) == (fused_regions(placed) > 0),
              f"explore IDCT8 {tag}: {n} stream-kernel launches for "
              f"{fused_regions(placed)} fused regions")
        if tag == "pinned":
            check(len(placed.hw_partitions) == 2,
                  f"explore IDCT8 pinned: {placed.hw_partitions}, not 2 hw partitions")
    link, link_points = measure_device_link()
    link_row = dict(latency_s=link.latency_s, bandwidth_Bps=link.bandwidth_Bps,
                    points=link_points, card=card)
    print(f"  device link (pinned, non_blocking H2D): latency {link.latency_s:.3e} s, "
          f"bandwidth {link.bandwidth_Bps / 1e9:.2f} GB/s on {card}", flush=True)
    check(link.bandwidth_Bps > 0 and math.isfinite(link.latency_s), "device link fit")
    for name, row in rows.items():
        print("  " + json.dumps(row), flush=True)
    return dict(rows=rows, launches=launches, multi=multi, link=link_row, c8=c8)


# ---------------------------------------------------------------------------
# Phase 13: StreamServe (FIR32, ``benchmarks/server_throughput.py``)
# ---------------------------------------------------------------------------

SERVE_NET = "FIR32"
SERVE_BLOCK = 1024
SERVE_SESSIONS = (1, 2, 4, 8, 16, 32)
SERVE_TOKENS = 262144  # per sweep point, split across the sessions
SCALE_SESSIONS, SCALE_TOKENS, SCALE_BLOCK, HOG_FACTOR = 1000, 256, 256, 64
# a mixed partition, as explore()'s scattered points make: Bitonic8's fused
# {ce0, ce4} beside an unfused ce2, 4 sessions of 2048 vectors
MIXED_HW, MIXED_VECTORS, MIXED_SESSIONS = ("ce0", "ce4", "ce2"), 2048, 4


def lcg_stream(n: int, mod: int = 100) -> list:
    """The Table-I networks' source stream: what a client submits."""
    return [float((x * 1103515245 + 12345) % mod) for x in range(n)]


def isolated_run(nets, name: str, n: int, block: int) -> list:
    """One stream's isolated ``run()`` on the card."""
    import repro_torch

    net, got = build_net(nets, name, n)
    repro_torch.compile(net, backend="device", block=block).run()
    return list(got)


def check_served(server, what: str, dispatched: bool = True) -> None:
    """The server met no fault and never degraded to the host (a CUDA
    partition's failed launch fails its sessions instead), and, where
    ``dispatched``, ran at least one round on the card."""
    faults = server.metrics.get("serve_faults_total").value
    degraded = server.metrics.get("serve_degraded").value
    rounds = server.telemetry.lifetime().device_dispatches
    check(faults == 0 and degraded == 0,
          f"{what}: {faults} faults, serve_degraded={degraded}")
    if dispatched:
        check(rounds >= 1, f"{what}: {rounds} device rounds")


def serve_once(prog, batching: bool, n_sessions: int, stream: list) -> dict:
    """Serve ``n_sessions`` copies of ``stream``; outputs, seconds, rounds,
    lanes, the stream kernel's launches and the latency summaries."""
    from repro_torch.kernels.stream_fused import kernel

    with prog.serve(batching=batching, max_batch=max(SERVE_SESSIONS),
                    admission_depth=2 * SERVE_BLOCK) as server:
        sessions = [server.open_session() for _ in range(n_sessions)]
        before = kernel.LAUNCHES
        t0 = time.perf_counter()
        for i in range(0, len(stream), SERVE_BLOCK):
            for s in sessions:
                s.submit(stream[i:i + SERVE_BLOCK], port="source")
        for s in sessions:
            s.close()
        drained = server.drain(timeout=600)
        secs = time.perf_counter() - t0
        launches = kernel.LAUNCHES - before
        t = server.telemetry.lifetime()
        ttfo = server.metrics.get("serve_ttfo_seconds").summary()
        ib = server.metrics.get("serve_interblock_seconds").summary()
        metrics_text = server.metrics_text()
        outs = [s.output("sink") for s in sessions]
        check_served(server, f"serve {'continuous' if batching else 'sequential'} "
                             f"B={n_sessions}")
    return dict(drained=drained, seconds=secs, outs=outs, rounds=t.device_dispatches,
                lanes=t.device_lanes, width=t.device_width, tokens_in=t.device_tokens_in,
                launches=launches, ttfo=ttfo, interblock=ib,
                has_metrics="serve_ttfo_seconds" in metrics_text)


def phase_stream_serve(nets) -> dict:
    import threading as _threading

    import repro_torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.core.cost_model import NetworkProfile
    from repro_torch.core.xcf import make_xcf
    from repro_torch.kernels.stream_fused import kernel
    from repro_torch.serve_stream import OnlineRepartitioner, StreamServer

    print("phase 13: StreamServe (FIR32, block 1024)", flush=True)
    net, _ = build_net(nets, SERVE_NET, SERVE_TOKENS)
    prog = repro_torch.compile(net, backend="device", block=SERVE_BLOCK)
    dp = prog.device_program()
    n_fused = sum(1 for members in (dp.fused or {}).values() if members)
    check(dp.lane_flat and n_fused == 1,
          f"serve: FIR32's partition is not one lane-flat fused region ({dp.fused})")
    full = lcg_stream(SERVE_TOKENS)
    serve_once(prog, True, 2, full[:2 * SERVE_BLOCK])  # the engine's paths, untimed
    serve_once(prog, False, 2, full[:2 * SERVE_BLOCK])
    kernel.LAUNCHES = 0  # the count covers the serving runs below only
    sweep, serve_launches, rounds_total = [], 0, 0
    for n in SERVE_SESSIONS:
        per = max(2 * SERVE_BLOCK, SERVE_TOKENS // n)
        ref = isolated_run(nets, SERVE_NET, per, SERVE_BLOCK)
        point = dict(sessions=n, tokens_per_session=per)
        for mode, batching in (("continuous", True), ("sequential", False)):
            launches_before = kernel.LAUNCHES
            r = serve_once(prog, batching, n, full[:per])
            serve_launches += kernel.LAUNCHES - launches_before
            rounds_total += r["rounds"]
            check(r["drained"], f"serve {mode} B={n}: drain timed out")
            check(all(o == ref for o in r["outs"]),
                  f"serve {mode} B={n}: a session != its isolated run bitwise")
            check(r["tokens_in"] == n * per, f"serve {mode} B={n}: {r['tokens_in']} tokens in")
            check(r["launches"] == n_fused * r["rounds"],
                  f"serve {mode} B={n}: {r['launches']} stream-kernel launches in "
                  f"{r['rounds']} rounds of {n_fused} fused program")
            if batching and n > 1:
                check(r["lanes"] > r["rounds"], f"serve B={n}: lanes never shared a round")
            check(r["has_metrics"], "serve: metrics_text() lacks the TTFO histogram")
            point[mode] = dict(
                seconds=r["seconds"], tokens_per_s=n * per / r["seconds"], rounds=r["rounds"],
                lanes=r["lanes"], width=r["width"], launches=r["launches"],
                launches_per_round=r["launches"] / max(r["rounds"], 1),
                ttfo_p50=r["ttfo"]["p50"], ttfo_p99=r["ttfo"]["p99"],
                interblock_p50=r["interblock"]["p50"], interblock_p99=r["interblock"]["p99"],
            )
        point["speedup"] = point["sequential"]["seconds"] / point["continuous"]["seconds"]
        print("  " + json.dumps(point), flush=True)
        sweep.append(point)

    # a mixed partition: the region's kernel still launches once a round
    net, _ = build_net(nets, "Bitonic8", MIXED_VECTORS)
    mixed = make_xcf("Bitonic8", {a: ("accel" if a in MIXED_HW else "t0")
                                  for a in net.graph().actors})
    mprog = repro_torch.compile(net, mixed, block=SERVE_BLOCK)
    mdp = mprog.device_program()
    check(not mdp.lane_flat and len(mdp.fused or {}) == 1 and len(mdp.actors) == 2,
          f"serve mixed: not one fused region beside one unfused actor ({mdp.actors})")
    mref = isolated_run(nets, "Bitonic8", MIXED_VECTORS, SERVE_BLOCK)
    r = serve_once(mprog, True, MIXED_SESSIONS, lcg_stream(8 * MIXED_VECTORS, mod=1000))
    check(r["drained"], "serve mixed: drain timed out")
    check(all(o == mref for o in r["outs"]), "serve mixed: a session != its isolated run bitwise")
    check(r["launches"] == r["rounds"] and r["lanes"] > r["rounds"],
          f"serve mixed: {r['launches']} stream-kernel launches in {r['rounds']} rounds "
          f"of {r['lanes']} lanes")
    mixed_row = dict(sessions=MIXED_SESSIONS, vectors=MIXED_VECTORS, members=mdp.actors,
                     megastep_k=mdp.megastep_k, rounds=r["rounds"], lanes=r["lanes"],
                     launches=r["launches"], seconds=r["seconds"])
    print("  mixed partition: " + json.dumps(mixed_row), flush=True)

    # the device's idle share over a steady stretch: 8 sessions of 16384
    stretch = full[:16384]
    window = profile_window(lambda: serve_once(prog, True, 8, stretch), 2,
                            match=("stream_fused_kernel",))
    check_window(window, "serve: profiled window")
    print(f"  serve window (8 sessions x 16384 tokens a call): idle share "
          f"{window['idle_share']:.5f}, device busy {window['device_busy_ms_per_call']:.3f} "
          f"ms in {window['ms_per_call']:.1f} ms a call", flush=True)

    # scale: 1000 short sessions plus one hog, chunked at admission
    net, _ = build_net(nets, SERVE_NET, SCALE_TOKENS)
    sprog = repro_torch.compile(net, backend="device", block=SCALE_BLOCK)
    small, hog_stream = lcg_stream(SCALE_TOKENS), lcg_stream(SCALE_TOKENS * HOG_FACTOR)
    small_ref = isolated_run(nets, SERVE_NET, SCALE_TOKENS, SCALE_BLOCK)
    hog_ref = isolated_run(nets, SERVE_NET, SCALE_TOKENS * HOG_FACTOR, SCALE_BLOCK)
    with sprog.serve(batching=True, max_batch=max(SERVE_SESSIONS),
                     admission_depth=2 * SCALE_BLOCK, admission_chunk=SCALE_BLOCK) as server:
        hog = server.open_session()
        smalls = [server.open_session() for _ in range(SCALE_SESSIONS)]
        t0 = time.perf_counter()
        hog_s = []

        def run_hog():
            hog.submit(hog_stream, port="source")
            hog_s.append(time.perf_counter() - t0)
            hog.close()

        th = _threading.Thread(target=run_hog)
        th.start()
        for s in smalls:
            s.submit(small, port="source")
            s.close()
        th.join(timeout=600)
        drained = server.drain(timeout=600)
        scale_s = time.perf_counter() - t0
        t = server.telemetry.lifetime()
        ttfo = sorted((s.first_delivery_ns - s.first_submit_ns) / 1e9 for s in smalls
                      if s.first_delivery_ns is not None)
        same = all(s.output("sink") == small_ref for s in smalls) and hog.output("sink") == hog_ref
        check_served(server, "serve scale")
    check(drained and not th.is_alive(), "serve scale: drain timed out")
    check(t.chunks_split >= 1, "serve scale: the hog was never chunked")
    check(len(ttfo) == SCALE_SESSIONS, "serve scale: a small session never delivered")
    check(same, "serve scale: a session != its isolated run bitwise")
    p95 = ttfo[round(0.95 * (len(ttfo) - 1))] if ttfo else float("nan")
    scale = dict(sessions=SCALE_SESSIONS, hog_tokens=len(hog_stream), seconds=scale_s,
                 tokens_per_s=(SCALE_SESSIONS * SCALE_TOKENS + len(hog_stream)) / scale_s,
                 chunks_split=t.chunks_split, small_ttfo_p50=ttfo[len(ttfo) // 2] if ttfo else None,
                 small_ttfo_p95=p95, hog_admission_s=hog_s[0] if hog_s else None,
                 mean_batch=t.mean_batch)
    print("  scale: " + json.dumps(scale), flush=True)

    # kill mid-stream with periodic checkpoints, then recover: bitwise
    n_kill = 65536
    kill_stream, kill_ref = lcg_stream(n_kill), isolated_run(nets, SERVE_NET, n_kill, SERVE_BLOCK)
    half = n_kill // 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        server = prog.serve(start=True, checkpoint_dir=tmp, checkpoint_every_s=0.05)
        s = server.open_session()
        for i in range(0, half, SERVE_BLOCK):
            s.submit(kill_stream[i:i + SERVE_BLOCK], port="source")
        after = ckpt.latest_step(tmp) or 0
        deadline = time.time() + 60
        while (ckpt.latest_step(tmp) or 0) <= after and time.time() < deadline:
            time.sleep(0.01)
        check((ckpt.latest_step(tmp) or 0) > after, "serve kill: no checkpoint after the submits")
        delivered = len(s.results["sink"])
        check_served(server, "serve before the kill", dispatched=False)
        server.kill()
        server2 = StreamServer.recover(prog, tmp, start=True)
        try:
            s2 = server2.session(0)
            for i in range(half, n_kill, SERVE_BLOCK):
                s2.submit(kill_stream[i:i + SERVE_BLOCK], port="source")
            s2.close()
            check(server2.drain(timeout=600), "serve recover: drain timed out")
            check(s2.output("sink") == kill_ref, "serve recover != uninterrupted bitwise")
            check_served(server2, "serve recovered")
            rec = server2.recovery.sessions[0]
            kill_row = dict(tokens=n_kill, delivered_before_kill=delivered,
                            restored=rec.delivered_restored, replay_bound=rec.replay_bound,
                            step=server2.recovery.step)
        finally:
            server2.stop()
    print("  kill and recover: " + json.dumps(kill_row), flush=True)

    # one online repartition: TopFilter served on the host, a calibration
    # profile pricing the filter near zero on the device; the first solve
    # moves it onto the card mid-stream (host and device compare the same
    # float32 tokens, so the outputs stay bitwise)
    n_top = 40000
    top_ref = isolated_run(nets, "TopFilter", n_top, SERVE_BLOCK)
    net, _ = build_net(nets, "TopFilter", n_top)
    tprog = repro_torch.compile(net, backend="host", block=SERVE_BLOCK)
    base = NetworkProfile()
    base.exec_hw["filter"] = 1e-9
    rep = OnlineRepartitioner(interval_s=0.0, min_window_s=0.0, min_gain=0.0,
                              thread_counts=(1,), base_profile=base)
    top_stream = lcg_stream(n_top)
    with tprog.serve(repartitioner=rep) as server:
        s = server.open_session()
        s.submit(top_stream[:n_top // 2], port="source")
        deadline = time.time() + 60
        while not server.telemetry.swap_log and time.time() < deadline:
            time.sleep(0.005)
        s.submit(top_stream[n_top // 2:], port="source")
        s.close()
        check(server.drain(timeout=600), "serve repartition: drain timed out")
        swaps = list(server.telemetry.swap_log)
        moved = bool(swaps) and swaps[0]["to"].get("filter") == "accel"
        on_card = {str(d.device) for d in server.program.device_programs().values()}
        same = s.output() == top_ref
        check_served(server, "serve repartition")
    check(moved, f"serve repartition: no move onto the device ({swaps[:1]})")
    check(on_card == {"cuda:0"}, f"serve repartition: device programs on {on_card}")
    check(same, "serve repartition: outputs != the isolated run bitwise")
    repart = dict(swaps=len(swaps), decisions=rep.decisions[:3], to=swaps[0]["to"] if swaps else None)
    print("  online repartition: " + json.dumps(repart), flush=True)
    return dict(sweep=sweep, window={k: v for k, v in window.items() if k != "top_kernels"},
                scale=scale, kill=kill_row, repartition=repart, mixed=mixed_row,
                launches=serve_launches,
                rounds=rounds_total)


# ---------------------------------------------------------------------------
# Phase 14: SSM and MoE training through the kernels
# ---------------------------------------------------------------------------

# mamba2-130m at full depth; deepseek-moe-16b at 4 of its 28 layers: its
# parameters, bf16 gradients and two float32 AdamW moments take about 12
# bytes a parameter (7 GB a layer, 5 GB for the embedding and head), and the
# functional update holds old and new moments at once
TRAIN_KERNELS = {
    "mamba2-130m": dict(layers=None, global_batch=8, seq_len=2048, steps=10, remat="block"),
    "deepseek-moe-16b": dict(layers=4, global_batch=4, seq_len=2048, steps=10,
                             remat="save_dispatch"),
}
TRAIN_OFF_TOL = 2e-2  # loss, and grad norm relative: one step against use_kernels="off"
# the worst gradient leaf's relative norm gap against "off", each layer of a
# stacked leaf on its own: sound runs read up to 0.14 (mamba2, a_log) and
# 0.19 (deepseek, the last layer's router and experts, where bf16 routing
# moves tokens between experts), and "off" in bf16 against "off" in float32
# reads up to 0.15 and 0.19 on the same leaves; a leaf whose gradient is
# wrong for a whole layer reads about 1
LEAF_TOL = 0.3
# the fault control: one layer's gradient of a leaf that the new backward
# writes, zeroed, must read over LEAF_TOL
LEAF_FAULT = {"mamba2-130m": ("layers/pos0/mixer/a_log", 0),
              "deepseek-moe-16b": ("layers/pos0/ffn/w_down", 0)}
# the CUDA-only branches of the training path at its shapes, against their
# float32 products: a bf16 result rounded once from float32 (dW, dx) within
# one bf16 ulp in norm, the head's float32 logits within float32 summation
PIECE_TOL = {"bf16": 2.0 ** -8, "float32": 1e-5}
GMM_FWD_SHAPES = (("gate_up", 1408), ("down", 2048))  # f of the forward product at d 2048/1408


def train_counts() -> dict:
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.ssd_scan import kernel as ssd

    return {**lm_counts(), "moe_gmm_dx": gmm.DX_LAUNCHES, "ssd_scan_bwd": ssd.BWD_LAUNCHES}


def zero_train_counts() -> None:
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.ssd_scan import kernel as ssd

    zero_lm_counts()
    gmm.DX_LAUNCHES = ssd.BWD_LAUNCHES = 0


def loss_and_grads(params, cfg, batch) -> dict:
    """One ``lm_loss`` forward and backward: the loss, the global gradient
    norm, the kernels launched in the forward and in the backward (the
    backward's include each block's recompute and, for ``moe_gmm``, dx),
    the peak device memory and the gradients (``grads``, in leaf order)."""
    from repro_torch.model import lm
    from repro_torch.optim import global_norm
    from repro_torch.pytree import tree_leaves

    leaves = tree_leaves(params)
    batch = {k: torch.from_numpy(v).to(leaves[0].device) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    loss, _ = lm.lm_loss(params, cfg, batch)
    torch.cuda.synchronize()
    fwd = train_counts()
    grads = torch.autograd.grad(loss, leaves)
    gn = float(global_norm(grads))
    bwd = {k: v - fwd[k] for k, v in train_counts().items()}
    return dict(loss=float(loss.detach()), grad_norm=gn, forward=fwd, backward=bwd,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, grads=list(grads))


def leaf_gaps(params, got, ref) -> dict:
    """||got - ref|| / ||ref|| in float32 for every gradient leaf, in leaf
    order of ``params``; a stacked layer leaf gives one gap a layer
    (``path[i]``)."""
    from repro_torch.pytree import tree_paths

    out = {}
    for (path, _), g, r in zip(tree_paths(params), got, ref):
        parts = list(zip(g, r)) if path.startswith("layers/") else [(g, r)]
        for i, (a, b) in enumerate(parts):
            key = f"{path}[{i}]" if len(parts) > 1 or path.startswith("layers/") else path
            ref_norm = torch.linalg.vector_norm(b.float())
            out[key] = float(torch.linalg.vector_norm(a.float() - b.float())
                             / ref_norm.clamp_min(1e-30))
    return out


def gap_summary(gaps: dict, ssm: bool) -> dict:
    """The worst gap of each group of leaves (the routed experts' stacked
    weights, the mixer's leaves: the SSD's or attention's, the head or tied
    embedding, the rest) and the five worst leaves."""
    def group(key):
        if "/ffn/w_" in key:
            return "experts"
        if "/mixer/" in key:
            return "ssd" if ssm else "attention"
        if key.startswith(("head/", "embed/")):
            return "head"
        return "other"

    worst = {}
    for key, gap in gaps.items():
        g = group(key)
        if gap >= worst.get(g, ("", -1.0))[1]:
            worst[g] = (key, gap)
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    return dict(max=max(gaps.values()), by_group=worst, top=top)


def backward_pieces(arch: str, cfg, B: int, S: int) -> dict:
    """Device ms of the new backwards' pieces a layer at the path's shape:
    the SSD scan's forward kernel and the grouped matmul's pieces (its
    forward kernel, the transposed weight copy, the dx kernel and the
    float32-accumulated dW ``bmm``, for the gate/up and the down products)
    from CUDA events around a CUDA graph's replays; the SSD backward (its
    kernels, on these bf16 tensors) on the device behind a spin kernel
    (``queued_ms``), and a call's wall time
    back to back from Python.  Beside them, each branch that runs only on
    the card, at these shapes, against its float32 product (``gaps``, the
    relative norm gap, held to ``PIECE_TOL``): the LM head's forward
    (``lm._HeadF32``) and, through ``GroupedMatmul``'s own backward, dx (the
    kernel on the transposed weights) and dW (``_dw``)."""
    from repro_torch.kernels.moe_gmm.ops import GroupedMatmul, _dw
    from repro_torch.model import lm
    from repro_torch.model.ssm import SSDScan

    gen = torch.Generator(device="cuda").manual_seed(14)
    bf = torch.bfloat16
    rows, gaps = {}, {}

    def gap(got, want):
        return float(torch.linalg.vector_norm(got.float() - want.float())
                     / torch.linalg.vector_norm(want.float()))

    # the head over one 512-token CE chunk of every batch row
    h = torch.randn(B * 512, cfg.d_model, generator=gen, device="cuda", dtype=bf)
    w = torch.randn(cfg.d_model, cfg.vocab_size, generator=gen, device="cuda", dtype=bf) * 0.02
    gaps["head_fwd"] = gap(lm._HeadF32.apply(h, w), torch.matmul(h.float(), w.float()))
    del h, w
    if cfg.ssm_state:
        nh, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        x = torch.randn(B, S, nh, P, generator=gen, device="cuda", dtype=bf)
        dt = torch.rand(B, S, nh, generator=gen, device="cuda") * 0.1 + 1e-3
        A = -torch.rand(nh, generator=gen, device="cuda") * 15 - 1
        Bm, Cm = (torch.randn(B, S, N, generator=gen, device="cuda", dtype=bf) for _ in range(2))
        ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
        y, _ = SSDScan.apply(*ins, cfg.ssm_chunk)
        gy = torch.randn_like(y)
        plain = [t.detach() for t in ins]
        rows["ssd_fwd_ms"] = device_ms(lambda: SSDScan.apply(*plain, cfg.ssm_chunk), 5)
        bwd = lambda: torch.autograd.grad(y, ins, gy, retain_graph=True)  # noqa: E731
        rows["ssd_bwd_ms"] = queued_ms(bwd, 3, spin_ms=80.0)
        rows["ssd_bwd_call_ms"] = call_ms(bwd, 3)
        grads = torch.autograd.grad(y, ins, gy, retain_graph=True)
        rows["ssd_bwd_finite"] = all(bool(torch.isfinite(g).all()) for g in grads)
    if cfg.moe:
        from repro_torch.kernels.moe_gmm.kernel import grouped_matmul_cuda
        from repro_torch.model.moe import _capacity

        E, d = cfg.num_experts, cfg.d_model
        G, Nt = (1, B * S) if B * S <= 4096 else (B, S)
        C = G * _capacity(Nt, cfg.experts_per_token, E, cfg.capacity_factor)
        for tag, f in GMM_FWD_SHAPES:
            k = d if tag == "gate_up" else cfg.moe_d_ff
            xb = torch.randn(E, C, k, generator=gen, device="cuda", dtype=bf)
            w = torch.randn(E, k, f, generator=gen, device="cuda", dtype=bf) * 0.02
            dy = torch.randn(E, C, f, generator=gen, device="cuda", dtype=bf)
            wt = w.transpose(1, 2).contiguous()
            xg, wg = xb.clone().requires_grad_(), w.clone().requires_grad_()
            dx, dw = torch.autograd.grad(GroupedMatmul.apply(xg, wg), (xg, wg), dy)
            gaps[f"gmm_{tag}_dx"] = gap(dx, torch.bmm(dy.float(), wt.float()).to(bf))
            gaps[f"gmm_{tag}_dw"] = gap(dw, torch.bmm(xb.float().transpose(1, 2),
                                                      dy.float()).to(bf))
            del xg, wg, dx, dw
            rows[f"gmm_{tag}"] = dict(
                E=E, C=C, d=k, f=f,
                fwd_ms=device_ms(lambda: grouped_matmul_cuda(xb, w), 5),
                transpose_copy_ms=device_ms(lambda: w.transpose(1, 2).contiguous(), 5),
                dx_ms=device_ms(lambda: grouped_matmul_cuda(dy, wt, dx=True), 5),
                dw_ms=device_ms(lambda: _dw(xb, dy, w.dtype), 5),
            )
    rows["gaps"] = gaps
    print(f"  {arch} backward pieces a layer (ms): " + json.dumps(rows), flush=True)
    check(gaps["head_fwd"] <= PIECE_TOL["float32"], f"{arch}: head forward gap {gaps}")
    for key, value in gaps.items():
        if key != "head_fwd":
            check(value <= PIECE_TOL["bf16"], f"{arch}: {key} gap {value} over one bf16 ulp")
    return rows


def phase_train_kernels() -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import MIXER_ATTN, MIXER_SSM
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, global_norm, init_opt_state
    from repro_torch.pytree import tree_map, tree_paths

    print("phase 14: SSM and MoE training through the kernels", flush=True)
    out = {}
    for arch, spec in TRAIN_KERNELS.items():
        cfg = dataclasses.replace(get_config(arch), remat=spec["remat"])
        if spec["layers"]:
            cfg = dataclasses.replace(cfg, num_layers=spec["layers"])
        B, S, steps = spec["global_batch"], spec["seq_len"], spec["steps"]
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                      seed=0))
        batches = [data.next_batch() for _ in range(steps)]
        params = lm.init_model(cfg, 0, device="cuda")
        row = dict(arch=arch, layers=cfg.num_layers, published_layers=get_config(arch).num_layers,
                   global_batch=B, seq_len=S, remat=cfg.remat)

        # one step's loss, grad norm and every gradient leaf on the same
        # params and batch, against "off"; beside it "off" against "off" in
        # float32 (the gaps bf16 rounding alone gives), and a fault control
        one = {"cuda": loss_and_grads(params, cfg, batches[0])}
        off = dataclasses.replace(cfg, use_kernels="off")
        one["off"] = loss_and_grads(params, off, batches[0])
        got, ref = one["cuda"].pop("grads"), one["off"].pop("grads")
        ssm = bool(cfg.ssm_state)
        gaps = {"cuda_vs_off": gap_summary(leaf_gaps(params, got, ref), ssm)}
        f32 = dataclasses.replace(off, dtype="float32", param_dtype="float32")
        wide = tree_map(lambda t: t.detach().float().requires_grad_(), params)
        exact = loss_and_grads(wide, f32, batches[0]).pop("grads")
        del wide
        gaps["bf16_off_vs_f32_off"] = gap_summary(leaf_gaps(params, ref, exact), ssm)
        gaps["cuda_vs_f32_off"] = gap_summary(leaf_gaps(params, got, exact), ssm)
        del exact
        path, layer = LEAF_FAULT[arch]
        paths = [p for p, _ in tree_paths(params)]
        bad = got[paths.index(path)].clone()
        bad[layer] = 0
        faulted = [bad if p == path else g for p, g in zip(paths, got)]
        gn_off = one["off"]["grad_norm"]
        gaps["fault"] = dict(
            leaf=f"{path}[{layer}]", zeroed=True,
            grad_norm_gap=abs(float(global_norm(faulted)) - gn_off) / gn_off,
            leaf_gap=leaf_gaps(params, faulted, ref)[f"{path}[{layer}]"])
        del got, ref, bad, faulted
        if cfg.moe:
            one["block"] = loss_and_grads(params, dataclasses.replace(cfg, remat="block"),
                                          batches[0])
            del one["block"]["grads"]
        row["one_step"], row["leaf_gaps"] = one, gaps
        print(f"  {arch}: one step " + json.dumps(one), flush=True)
        print(f"  {arch}: gradient leaves' relative gaps " + json.dumps(gaps), flush=True)
        k, o = one["cuda"], one["off"]
        check(abs(k["loss"] - o["loss"]) <= TRAIN_OFF_TOL,
              f"{arch} train: loss {k['loss']} vs off {o['loss']}")
        check(abs(k["grad_norm"] - o["grad_norm"]) <= TRAIN_OFF_TOL * abs(o["grad_norm"]),
              f"{arch} train: grad norm {k['grad_norm']} vs off {o['grad_norm']}")
        check(gaps["cuda_vs_off"]["max"] <= LEAF_TOL,
              f"{arch} train: a gradient leaf off \"off\"'s by "
              f"{gaps['cuda_vs_off']['top'][0]}, over {LEAF_TOL}")
        check(gaps["fault"]["leaf_gap"] > LEAF_TOL,
              f"{arch} train: the leaf check misses a zeroed gradient ({gaps['fault']})")
        name = "moe_gmm" if cfg.moe else "ssd_scan"
        check(k["forward"][name] > 0 and k["backward"][name] > 0,
              f"{arch} train: {name} launches forward {k['forward'][name]} backward "
              f"{k['backward'][name]}")
        check(k["forward"]["rmsnorm"] > 0, f"{arch} train: rmsnorm never launched")
        ssd_layers = sum(cfg.block_kind(i).mixer == MIXER_SSM for i in range(cfg.num_layers))
        check(k["backward"]["ssd_scan_bwd"] == ssd_layers and k["forward"]["ssd_scan_bwd"] == 0,
              f"{arch} train: ssd_scan backward launches forward {k['forward']['ssd_scan_bwd']} "
              f"backward {k['backward']['ssd_scan_bwd']}, expected 0 and {ssd_layers}")
        if cfg.moe:
            check(k["backward"]["moe_gmm_dx"] > 0 and k["forward"]["moe_gmm_dx"] == 0,
                  f"{arch} train: moe_gmm dx launches {k['backward']['moe_gmm_dx']}")
            check(k["loss"] == one["block"]["loss"],
                  f"{arch} train: save_dispatch loss {k['loss']} != block's "
                  f"{one['block']['loss']}")
            check(k["forward"] == one["block"]["forward"],
                  f"{arch} train: save_dispatch's forward launches differ from block's")
        if any(kind.mixer == MIXER_ATTN for kind in cfg.pattern()):
            check(k["forward"]["flash_fwd"] > 0 and k["backward"]["flash_bwd_dq"] > 0,
                  f"{arch} train: flash kernels never launched")
        del one

        # the training run: run_training's step on its own batches
        opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
        opt_state = init_opt_state(params, opt)
        step = make_train_step(cfg, opt)
        losses, seconds = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_train_counts()
        for i in range(steps):
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batches[i])
            losses.append(float(m["loss"]))  # waits for the step
            seconds.append(time.perf_counter() - t0)
        launches = train_counts()
        steady = sorted(seconds[1:])
        row.update(losses=losses, step_seconds=seconds, median_step_s=steady[len(steady) // 2],
                   launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
                   train_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        row["tokens_per_s"] = B * S / row["median_step_s"]
        print(f"  {arch}: " + json.dumps({k: row[k] for k in (
            "layers", "losses", "median_step_s", "tokens_per_s", "launches_per_step",
            "train_peak_gb")}), flush=True)
        check(all(math.isfinite(x) for x in losses), f"{arch} train: non-finite loss")
        check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"{arch} train: loss did not fall")
        check(launches[name] > 0, f"{arch} train: {name} never launched in the run")

        prof = profile_window(lambda: step(params, opt_state, batches[0]), 3)
        check_window(prof, f"{arch} train: profiled window")
        row["profiled"] = prof
        print(f"  {arch}: " + json.dumps({"profiled": prof}), flush=True)
        del params, opt_state, step
        torch.cuda.empty_cache()
        row["pieces"] = backward_pieces(arch, cfg, B, S)
        if cfg.ssm_state:
            check(row["pieces"]["ssd_bwd_finite"], f"{arch}: SSD backward not finite")
        torch.cuda.empty_cache()
        out[arch] = row
    return out


# ---------------------------------------------------------------------------
# Phase 15: the sharded path on a one-rank mesh
# ---------------------------------------------------------------------------

SHARDED = dict(arch="smollm-135m", steps=3, global_batch=8, seq_len=2048)
# a smollm-135m training step's launches, as phase 5 counts them
SHARDED_STEP_LAUNCHES = {"flash_fwd": 60, "flash_bwd_dq": 30, "flash_bwd_dkv": 30,
                         "rmsnorm": 121}
SHARDED_PREFILL = dict(arch="mamba2-130m", batch=8, seq_len=2048, ssd_calls=24)
SHARDED_MOE = dict(arch="deepseek-moe-16b", layers=2, batch=4, seq_len=2048)


def grads_of(params, cfg, batch, mesh=None, rules=None) -> dict:
    """One ``lm_loss`` forward and backward, under ``shard_ctx(mesh, rules)``
    with the batch placed by its logical axes when a mesh is given: the loss,
    the gradients (as given, and gathered in leaf order), the launches of
    the forward and of the backward, and the peak device memory with the
    memory allocated when the forward starts (``start_gb``)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.model import lm
    from repro_torch.pytree import tree_leaves

    leaves = tree_leaves(params)
    with sh.shard_ctx(mesh, rules) if mesh is not None else contextlib.nullcontext():
        b = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
        if mesh is not None:
            b = {k: sh.distribute_tensor(t, mesh, sh.ctx_placements(("batch", "seq"), t.shape))
                 for k, t in b.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start_gb = torch.cuda.memory_allocated() / 1e9
        zero_train_counts()
        loss, _ = lm.lm_loss(params, cfg, b)
        torch.cuda.synchronize()
        fwd = train_counts()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    bwd = {k: v - fwd[k] for k, v in train_counts().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9  # before the gathered copies below
    full = lambda t: t.full_tensor() if isinstance(t, sh.DTensor) else t  # noqa: E731
    return dict(loss=full(loss.detach()), grads=list(grads), plain=[full(g) for g in grads],
                forward=fwd, backward=bwd, peak_gb=peak_gb, start_gb=start_gb)


def same_bits(got: list, ref: list) -> list:
    """Leaf indices whose bits differ."""
    return [i for i, (a, b) in enumerate(zip(got, ref)) if not bits_equal(a, b)]


def phase_sharded() -> dict:
    """The slice's sharded path on a (1, 1) mesh over a one-rank NCCL group:
    DTensor parameters, moments and batches under ``shard_ctx``, every
    kernel behind its ``local_map`` boundary, held bitwise to the same runs
    without a context (one rank: nothing is partial, nothing moves)."""
    import dataclasses
    import os

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.compression import all_reduce_int8
    from repro_torch.kernels.quant import kernel as quant
    from repro_torch.kernels.quant.ops import dequantize_int8, quantize_int8
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, global_norm, init_opt_state
    from repro_torch.pytree import tree_leaves

    print("phase 15: sharded (DTensor) steps on a one-rank mesh", flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh()
            check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
                  and tuple(mesh.mesh_dim_names) == ("data", "model"),
                  f"sharded: make_test_mesh gave {mesh}")

            # smollm-135m training, 3 AdamW steps with and without the context
            cfg = get_config(SHARDED["arch"])
            B, S, n = SHARDED["global_batch"], SHARDED["seq_len"], SHARDED["steps"]
            opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=n)
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                          seed=0))
            batches = [data.next_batch() for _ in range(n)]
            params = lm.init_model(cfg, 0, device="cuda")
            rules = sh.make_rules(cfg, mesh)
            placed = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
            step_fn = make_train_step(cfg, opt)
            full = lambda t: t.full_tensor() if isinstance(t, sh.DTensor) else t  # noqa: E731
            runs = {}
            for name, p0, m in (("plain", params, None), ("sharded", placed, mesh)):
                p, st = p0, init_opt_state(p0, opt)
                steps, launches = [], dict.fromkeys(SHARDED_STEP_LAUNCHES, 0)
                for i in range(n):
                    # the gradients, leaf by leaf, of one lm_loss backward at the
                    # step's parameters; then the step itself, the one profiled below
                    g = grads_of(p, cfg, batches[i], m, rules)
                    zero_train_counts()
                    with sh.shard_ctx(m, rules) if m is not None else contextlib.nullcontext():
                        p, st, met = step_fn(p, st, batches[i])
                    torch.cuda.synchronize()
                    launches = {k: v + train_counts()[k] for k, v in launches.items()}
                    steps.append(dict(loss=g["loss"], step_loss=full(met["loss"]),
                                      grads=g["plain"], peak_gb=g["peak_gb"],
                                      start_gb=g["start_gb"],
                                      grad_norm=float(full(met["grad_norm"]))))
                    del g
                runs[name] = dict(steps=steps, launches=launches,
                                  final=[full(t) for t in tree_leaves((p, st))])
            plain, shard = runs["plain"], runs["sharded"]
            for i, (a, b) in enumerate(zip(plain["steps"], shard["steps"])):
                for r in (a, b):
                    check(bits_equal(r["step_loss"], r["loss"]),
                          f"sharded: smollm step {i}: make_train_step's loss "
                          f"{float(r['step_loss'])} != lm_loss's {float(r['loss'])}")
                check(bits_equal(a["step_loss"], b["step_loss"]),
                      f"sharded: smollm step {i} loss {float(b['step_loss'])} != "
                      f"{float(a['step_loss'])}")
                bad = same_bits(b["grads"], a["grads"])
                check(not bad, f"sharded: smollm step {i}: {len(bad)} gradient leaves differ")
            bad = same_bits(shard["final"], plain["final"])
            check(not bad, f"sharded: smollm parameters and optimizer state after {n} steps: "
                  f"{len(bad)} leaves differ from the unsharded run's")
            per_step = {k: v / n for k, v in shard["launches"].items()}
            check(per_step == SHARDED_STEP_LAUNCHES,
                  f"sharded: launches a step {per_step}, expected {SHARDED_STEP_LAUNCHES}")
            check(shard["launches"] == plain["launches"],
                  f"sharded: launches {shard['launches']} != unsharded {plain['launches']}")
            st0 = init_opt_state(params, opt)
            prof_plain = profile_window(lambda: step_fn(params, st0, batches[0]), 3)
            check_window(prof_plain, "sharded: unsharded step window")
            sst0 = init_opt_state(placed, opt)

            def sharded_step():
                with sh.shard_ctx(mesh, rules):
                    return step_fn(placed, sst0, batches[0])

            prof_shard = profile_window(sharded_step, 3)
            check_window(prof_shard, "sharded: sharded step window")
            del st0, sst0
            train = dict(
                arch=cfg.name, global_batch=B, seq_len=S, steps=n,
                losses={k: [float(s["step_loss"]) for s in r["steps"]] for k, r in runs.items()},
                grad_norms={k: [s["grad_norm"] for s in r["steps"]] for k, r in runs.items()},
                launches=shard["launches"], launches_per_step=per_step,
                host_ms_per_step={"plain": prof_plain["ms_per_call"],
                                  "sharded": prof_shard["ms_per_call"]},
                device_busy_ms_per_step={"plain": prof_plain["device_busy_ms_per_call"],
                                         "sharded": prof_shard["device_busy_ms_per_call"]},
                idle_share={"plain": prof_plain["idle_share"],
                            "sharded": prof_shard["idle_share"]},
            )
            print("  smollm: " + json.dumps(train), flush=True)

            # batch_chunks=2 against batch_chunks=1, both under the context
            one = shard["steps"][0]
            two = grads_of(placed, dataclasses.replace(cfg, batch_chunks=2), batches[0], mesh,
                           rules)
            gn1, gn2 = float(global_norm(one["grads"])), float(global_norm(two["plain"]))
            gaps = leaf_gaps(params, two["plain"], one["grads"])
            worst = max(gaps.items(), key=lambda kv: kv[1])
            chunks = dict(loss={"1": float(one["loss"]), "2": float(two["loss"])},
                          grad_norm={"1": gn1, "2": gn2}, worst_leaf=worst,
                          peak_gb={"1": one["peak_gb"], "2": two["peak_gb"]},
                          start_gb={"1": one["start_gb"], "2": two["start_gb"]})
            print("  batch_chunks: " + json.dumps(chunks), flush=True)
            check(abs(float(two["loss"]) - float(one["loss"])) <= TRAIN_OFF_TOL,
                  f"sharded: batch_chunks=2 loss {chunks['loss']}")
            check(abs(gn2 - gn1) <= TRAIN_OFF_TOL * abs(gn1),
                  f"sharded: batch_chunks=2 grad norm {chunks['grad_norm']}")
            check(worst[1] <= LEAF_TOL, f"sharded: batch_chunks=2 leaf {worst} over {LEAF_TOL}")
            train["batch_chunks"] = chunks
            out["train"] = train
            del runs, plain, shard, one, two, params, placed
            torch.cuda.empty_cache()

            # mamba2-130m prefill through the SSD scan kernel
            cfg = get_config(SHARDED_PREFILL["arch"])
            params = lm.init_model(cfg, 0, device="cuda")
            rules = sh.make_rules(cfg, mesh)
            placed = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
            toks = torch.from_numpy(np.random.default_rng(2).integers(
                3, cfg.vocab_size, (SHARDED_PREFILL["batch"], SHARDED_PREFILL["seq_len"]))
            ).to("cuda")
            prefill = make_prefill_step(cfg)
            logits, cache = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            zero_lm_counts()
            with sh.shard_ctx(mesh, rules):
                stoks = sh.distribute_tensor(toks, mesh, sh.ctx_placements(("batch", "seq"),
                                                                           toks.shape))
                slogits, scache = prefill(placed, {"tokens": stoks})
                torch.cuda.synchronize()
            ssd_calls = lm_counts()["ssd_scan"]
            same = bits_equal(slogits.full_tensor(), logits) and not same_bits(
                [t.full_tensor() for t in tree_leaves(scache)], tree_leaves(cache))
            out["prefill"] = dict(arch=cfg.name, batch=SHARDED_PREFILL["batch"],
                                  seq_len=SHARDED_PREFILL["seq_len"], ssd_scan=ssd_calls,
                                  bitwise=same)
            print("  mamba2 prefill: " + json.dumps(out["prefill"]), flush=True)
            check(ssd_calls == SHARDED_PREFILL["ssd_calls"],
                  f"sharded: {ssd_calls} SSD-scan calls, expected {SHARDED_PREFILL['ssd_calls']}")
            check(same, "sharded: mamba2 prefill logits or final states differ from unsharded")
            del params, placed, logits, cache, slogits, scache
            torch.cuda.empty_cache()

            # deepseek-moe-16b, one loss and backward through moe_gmm
            cfg = dataclasses.replace(get_config(SHARDED_MOE["arch"]),
                                      num_layers=SHARDED_MOE["layers"])
            params = lm.init_model(cfg, 0, device="cuda")
            rules = sh.make_rules(cfg, mesh)
            placed = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
            batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=SHARDED_MOE["seq_len"],
                                           global_batch=SHARDED_MOE["batch"], seed=0)).next_batch()
            ref = grads_of(params, cfg, batch)
            # the unsharded gradients (3.19 GB) leave the card, so that both
            # runs start from the same resident memory
            ref["plain"] = [g.cpu() for g in ref["plain"]]
            ref["grads"] = None
            got = grads_of(placed, cfg, batch, mesh, rules)
            got["plain"] = [g.cpu() for g in got["plain"]]
            moe = dict(arch=cfg.name, layers=cfg.num_layers, batch=SHARDED_MOE["batch"],
                       seq_len=SHARDED_MOE["seq_len"], loss=float(got["loss"]),
                       forward=got["forward"], backward=got["backward"],
                       peak_gb={"plain": ref["peak_gb"], "sharded": got["peak_gb"]},
                       start_gb={"plain": ref["start_gb"], "sharded": got["start_gb"]})
            bad = same_bits(got["plain"], ref["plain"])
            moe["bitwise"] = bits_equal(got["loss"], ref["loss"]) and not bad
            print("  deepseek: " + json.dumps(moe), flush=True)
            check(moe["bitwise"], f"sharded: deepseek loss or {len(bad)} gradient leaves differ")
            check(got["forward"]["moe_gmm"] > 0 and got["backward"]["moe_gmm_dx"] > 0
                  and got["forward"] == ref["forward"] and got["backward"] == ref["backward"],
                  f"sharded: deepseek launches {got['forward']} / {got['backward']} against "
                  f"{ref['forward']} / {ref['backward']}")
            out["moe"] = moe
            del params, placed, ref, got
            torch.cuda.empty_cache()

            # all_reduce_int8 over the mesh's data axis: the round trip
            x = torch.randn(576, 4096, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator(device="cuda").manual_seed(3))
            quant.LAUNCHES = 0
            with sh.shard_ctx(mesh, sh.make_rules(get_config(SHARDED["arch"]), mesh)):
                red = all_reduce_int8(x, "data")
            torch.cuda.synchronize()
            q_launches = quant.LAUNCHES
            want = dequantize_int8(*quantize_int8(x)).to(x.dtype)
            out["int8"] = dict(launches=q_launches, bitwise=bits_equal(red, want))
            print("  all_reduce_int8(x, 'data'): " + json.dumps(out["int8"]), flush=True)
            check(out["int8"]["bitwise"] and q_launches == 1,
                  f"sharded: all_reduce_int8 over the data axis {out['int8']}")
        finally:
            dist.destroy_process_group()
    out["launches"] = dict(
        **train["launches"], ssd_scan=out["prefill"]["ssd_scan"],
        moe_gmm=out["moe"]["forward"]["moe_gmm"] + out["moe"]["backward"]["moe_gmm"],
        moe_gmm_dx=out["moe"]["backward"]["moe_gmm_dx"], quantize_int8=q_launches)
    return out


# ---------------------------------------------------------------------------
# Phase 16: the dry-run, held to real steps on the card, and the production
# cells traced on a fake process group
# ---------------------------------------------------------------------------

# (name, arch, kind, global batch, sequence): phase 5's training cell and
# phase 15's prefill, at published widths and depth
DRYRUN_CARD = (("train", "smollm-135m", "train", 8, 2048),
               ("prefill", "mamba2-130m", "prefill", 8, 2048))
DRYRUN_LAUNCHES = {"smollm-135m": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rmsnorm"),
                   "mamba2-130m": ("ssd_scan", "rmsnorm")}
# (arch, shape, multi-pod) traced by ``python -m repro_torch.launch.dryrun``
DRYRUN_CELLS = (("smollm-135m", "train_4k", False), ("smollm-135m", "prefill_32k", False),
                ("smollm-135m", "decode_32k", False), ("mamba2-130m", "train_4k", False),
                ("deepseek-moe-16b", "decode_32k", True))
DRYRUN_CELL_SECONDS = 900  # each cell's subprocess, all of them at once
PEAK_TOL = 0.15  # predicted peak memory against max_memory_allocated
FLOP_GAP_TOL = 0.01  # predicted FLOPs against FlopCounterMode on the real "off" step
BF16_PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores, NVIDIA's datasheet


def start_dryrun_cells(out_dir: str) -> dict:
    """One ``python -m repro_torch.launch.dryrun`` process per production
    cell, all started at once on the host's CPU (its tensors are meta
    tensors: nothing runs on the card)."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = {}
    for arch, shape, multi_pod in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", out_dir]
        cmd += ["--multi-pod"] if multi_pod else []
        tag = f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"
        procs[tag] = (subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), time.perf_counter())
    return procs


def finish_dryrun_cells(procs: dict, out_dir: str) -> dict:
    """Wait for every cell (killing any past ``DRYRUN_CELL_SECONDS``), print
    one line a cell and fail the run on any cell that did not end ``ok``."""
    rows = {}
    t_start = min(t0 for _, t0 in procs.values())
    try:
        for tag, (p, t0) in procs.items():
            try:
                log = p.communicate(timeout=max(1.0, DRYRUN_CELL_SECONDS - (time.perf_counter() - t0)))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0]
            path = Path(out_dir) / f"{tag}.json"
            res = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
            rows[tag] = dict(res, rc=p.returncode)
            if res.get("status") != "ok":
                print(f"  {tag}: {res.get('status')} rc {p.returncode}: "
                      f"{res.get('error')}\n{res.get('traceback', '')[-2000:]}\n{log[-2000:]}",
                      flush=True)
                check(False, f"dryrun: production cell {tag} did not end ok")
                continue
            a, mem = res["analyzed"], res["memory_analysis"]
            print(f"  {tag}: flops/dev {a['flops']:.6e}, collective bytes/dev "
                  f"{a['collective_bytes']:.6e} (ICI {a['ici_bytes']:.6e}, DCN "
                  f"{a['dcn_bytes']:.6e}), arguments {mem['argument_size_in_bytes'] / 2**30:.4f} "
                  f"GiB/dev, temp {mem['temp_size_in_bytes'] / 2**30:.4f} GiB/dev, trace "
                  f"{res['t_trace_s']} s", flush=True)
        print(f"  every cell done {time.perf_counter() - t_start:.1f} s after the first "
              f"started", flush=True)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return rows


def real_args(cfg, kind: str, B: int, S: int, specs) -> tuple:
    """The cell's arguments as real tensors on the card, seeded: the
    parameters of ``init_model`` (requiring grad), AdamW's state and int32
    tokens (and labels), each of the dry-run's spec's shape and dtype."""
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.pytree import tree_leaves

    params = lm.init_model(cfg, 0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    tok = lambda: torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,  # noqa: E731
                                device="cuda", generator=g)
    if kind == "train":
        args = (params, init_opt_state(params, OptConfig()), {"tokens": tok(), "labels": tok()})
    else:
        args = (params, {"tokens": tok()})
    for a, s in zip(tree_leaves(args), tree_leaves(specs)):
        assert a.shape == s.shape and a.dtype == s.dtype, (a.shape, s.shape, a.dtype, s.dtype)
    return args


def step_peak(step, args) -> dict:
    """One call of ``step`` after a warm-up call: the card's peak allocated
    bytes over it (``max_memory_allocated``, reset just before) and the bytes
    allocated when it starts."""
    import gc

    step(*args)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return dict(start=start, peak=peak)


def phase_dryrun() -> dict:
    """The dry-run (``repro_torch.launch.dryrun``): its unsharded prediction
    against real steps on the card, and the production cells."""
    import dataclasses
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun import analyze_cell
    from repro_torch.launch.hlo_analysis import tensor_bytes
    from repro_torch.launch.steps import cell_specs

    print("phase 16: dry-run: predictions against the card, production cells", flush=True)
    out = {"card": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as cells_dir:
        procs = start_dryrun_cells(cells_dir)  # on the host's CPU while the card works
        for name, arch, kind, B, S in DRYRUN_CARD:
            cfg = get_config(arch)
            off = dataclasses.replace(cfg, use_kernels="off")
            cell = ShapeCell(f"card_{name}", S, B, kind)
            pred = analyze_cell(cfg, cell)
            mem = pred["memory_analysis"]
            pred_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            step_off, specs, _ = cell_specs(off, cell)
            args = real_args(cfg, kind, B, S, specs)
            arg_bytes = tensor_bytes(args)
            row = dict(arch=arch, kind=kind, batch=B, seq_len=S, pred_flops=pred["analyzed"]["flops"],
                       pred_argument_bytes=mem["argument_size_in_bytes"], real_argument_bytes=arg_bytes,
                       pred_peak_bytes=pred_peak, model_flops_global=pred["model_flops_global"],
                       trace_s=pred["t_trace_s"])
            check(arg_bytes == mem["argument_size_in_bytes"],
                  f"dryrun {name}: argument bytes {mem['argument_size_in_bytes']} predicted, "
                  f"{arg_bytes} real")
            with FlopCounterMode(display=False) as fc:
                step_off(*args)
            torch.cuda.synchronize()
            row["real_off_flops"] = float(fc.get_total_flops())
            gap = abs(row["real_off_flops"] - row["pred_flops"]) / row["pred_flops"]
            row["flop_gap"] = gap
            if gap > FLOP_GAP_TOL:  # print the ops that differ: each needs an explanation
                real_by = {str(k): float(v) for k, v in fc.get_flop_counts()["Global"].items()}
                diff = {k: (pred["flops_by_op"].get(k, 0.0), real_by.get(k, 0.0))
                        for k in set(real_by) | set(pred["flops_by_op"])
                        if pred["flops_by_op"].get(k, 0.0) != real_by.get(k, 0.0)}
                print(f"  {name}: FLOPs by op, predicted against counted: {diff}", flush=True)
            check(gap <= FLOP_GAP_TOL, f"dryrun {name}: FLOPs {row['pred_flops']:.6e} predicted, "
                  f"{row['real_off_flops']:.6e} counted on the card's 'off' step (gap {gap:.4%})")
            for path, cfg_p in (("off", off), ("cuda", cfg)):
                step = cell_specs(cfg_p, cell)[0]
                zero_lm_counts()
                mem_row = step_peak(step, args)
                launches = {k: lm_counts()[k] for k in DRYRUN_LAUNCHES[arch]}
                prof = profile_window(lambda: step(*args), 3)
                check_window(prof, f"dryrun {name} {path}: profiled window")
                busy_s = prof["device_busy_ms_per_call"] / 1e3
                held = mem_row["start"] - arg_bytes  # bytes on the card that are no argument
                measured = mem_row["peak"] - held
                row[path] = dict(
                    peak_bytes=mem_row["peak"], start_bytes=mem_row["start"], held_bytes=held,
                    peak_less_held_bytes=measured, launches=launches,
                    device_busy_ms=prof["device_busy_ms_per_call"], idle_share=prof["idle_share"],
                    step_mfu=pred["model_flops_global"] / (busy_s * BF16_PEAK_FLOPS))
                if path == "off":
                    rel = abs(pred_peak - measured) / measured
                    row["off"]["peak_rel_err"] = rel
                    check(rel <= PEAK_TOL, f"dryrun {name}: predicted peak {pred_peak} B against "
                          f"{measured} B measured on the 'off' step ({rel:.2%})")
                else:
                    for k, n in launches.items():
                        check(n > 0, f"dryrun {name}: {k} was never launched on the kernel path")
                print(f"  {name} ({arch}, {kind} {B} x {S}) {path}: peak "
                      f"{mem_row['peak'] / 1e9:.6f} GB (start {mem_row['start'] / 1e9:.6f}, of it "
                      f"{held / 1e9:.6f} no argument), device busy "
                      f"{prof['device_busy_ms_per_call']:.3f} ms a step, idle "
                      f"{prof['idle_share']:.3f}, step_mfu {row[path]['step_mfu']:.4f} "
                      f"(model FLOPs {pred['model_flops_global']:.6e} over busy seconds x "
                      f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s, the H100 SXM's dense bf16 "
                      f"peak); launches "
                      f"{launches}", flush=True)
            print(f"  {name}: predicted FLOPs {row['pred_flops']:.6e}, FlopCounterMode on the "
                  f"card's 'off' step {row['real_off_flops']:.6e} (gap {gap:.4%}); arguments "
                  f"{arg_bytes} B predicted and real; predicted peak {pred_peak / 1e9:.6f} GB "
                  f"against {row['off']['peak_less_held_bytes'] / 1e9:.6f} GB on the 'off' step "
                  f"({row['off']['peak_rel_err']:.2%}); trace {pred['t_trace_s']} s", flush=True)
            out["card"][name] = row
            del args
            gc.collect()
            torch.cuda.empty_cache()
        out["cells"] = finish_dryrun_cells(procs, cells_dir)
    return out


EXAMPLES = Path(__file__).resolve().parent / "examples"
# the kernels each twin must launch on the card (examples/*_torch.py); TopFilter
# has no fused region (its filter's rate depends on the data), so
# partition_explore's device partition runs torch ops and no stream kernel
FLASH_AND_NORM = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "rmsnorm")
SERVE_KERNELS = {"smollm-135m": ("rmsnorm",), "mamba2-130m": ("rmsnorm", "ssd_scan"),
                 "deepseek-moe-16b": ("rmsnorm", "moe_gmm")}
TRAIN_EXAMPLE_STEPS = 80  # crosses the failure injected at 60 and checkpoints 25, 50, 75
PIPELINE_SECONDS = 600
PIPELINE_RUNNER = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("pipeline_lm_torch", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
out = mod.main([])
out.pop("output")
print("RESULT " + json.dumps(out), flush=True)
"""


def load_example(name: str):
    """``examples/<name>.py`` as a module, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def count_calls(mod, fn_name: str, counts, zero, into: dict) -> None:
    """Wrap ``mod.<fn_name>`` so that each call's kernel launches land in
    ``into[first argument]`` (counts set to 0 just before, read just after)."""
    fn = getattr(mod, fn_name)

    def wrapped(*args, **kw):
        zero()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        into[args[0]] = counts()
        return out

    setattr(mod, fn_name, wrapped)


def run_example(name: str, fn, out: dict) -> None:
    """Run one twin, its seconds and result (or the failure) into ``out``."""
    import traceback

    print(f"  --- examples/{name}_torch.py", flush=True)
    t0 = time.perf_counter()
    try:
        out[name] = fn()
    except Exception:  # noqa: BLE001 — recorded as a failed check, fails the run
        check(False, f"examples: {name}_torch raised:\n{traceback.format_exc()[-3000:]}")
        out[name] = None
        return
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out[name]["seconds"] = time.perf_counter() - t0


def launched(name: str, counts: dict, kernels) -> None:
    missing = [k for k in kernels if not counts.get(k)]
    check(not missing, f"examples: {name} launched no {missing} ({counts})")


def phase_examples(card: str) -> dict:
    """The six example twins on the card, each passing its own checks and
    launching each kernel of its path."""
    from repro_torch.kernels.stream_fused import kernel as stream

    print(f"phase 17: examples (examples/*_torch.py) on {card}", flush=True)
    out: dict = {}

    def stream_counts():
        return {"fused_stream": stream.LAUNCHES}

    def zero_stream():
        stream.LAUNCHES = 0

    def hetero():
        mod = load_example("heterogeneous_stream_torch")
        per = {}
        count_calls(mod, "run", stream_counts, zero_stream, per)
        res = mod.main([])
        for net in ("Bitonic8", "IDCT8"):
            check(res[net]["outputs_match"], f"examples: heterogeneous_stream {net} outputs")
            launched(f"heterogeneous_stream {net}", per[net], ("fused_stream",))
            res[net] = {k: v for k, v in res[net].items() if k not in ("host", "device")}
        res["launches"] = {"fused_stream": {net: c["fused_stream"] for net, c in per.items()}}
        return res

    def explore():
        zero_stream()
        res = load_example("partition_explore_torch").main([])
        res["launches"] = {"fused_stream": {"TopFilter": stream.LAUNCHES}}
        check(res["outputs_match"], "examples: partition_explore outputs")
        check(all(d == "cuda:0" for d in res["ran_on"].values()),
              f"examples: partition_explore partitions ran on {res['ran_on']}")
        check(bool(res["ran_on"]) == bool(res["best_hw_actors"]) and (
            not res["ran_on"] or res["plink_launches"] >= 1),
            f"examples: partition_explore best point {res['best_hw_actors']}, partitions "
            f"{res['ran_on']}, {res['plink_launches']} PLink launches")
        return {k: v for k, v in res.items() if k not in ("host", "best", "plans")}

    def serve():
        mod = load_example("serve_decode_torch")
        per = {}
        count_calls(mod, "run_serving", lm_counts, zero_lm_counts, per)
        res = mod.main(["--full"])
        for arch, kernels in SERVE_KERNELS.items():
            r = res[arch]
            check(1 <= r["steps"] <= 16 and r["output"].shape == (4, 16),
                  f"examples: serve_decode {arch} output {r['output'].shape}, "
                  f"{r['steps']} steps")
            launched(f"serve_decode {arch}", per[arch], kernels)
            res[arch] = dict(
                steps=r["steps"], prefill_s=r["prefill_seconds"],
                decode_s=r["decode_seconds"],
                prefill_tok_s=4 * 16 / r["prefill_seconds"],
                decode_tok_s=4 * (r["steps"] - 1) / max(r["decode_seconds"], 1e-9))
        res["launches"] = {k: {arch: c[k] for arch, c in per.items()}
                           for k in ("rmsnorm", "ssd_scan", "moe_gmm")}
        return res

    def train():
        zero_lm_counts()
        res = load_example("train_smollm_torch").main(
            ["--full", "--steps", str(TRAIN_EXAMPLE_STEPS)])
        torch.cuda.synchronize()
        res["launches"] = lm_counts()
        check(res["steps"] == TRAIN_EXAMPLE_STEPS and res["restarts"] == 1 and res["improved"]
              and res["finite"], f"examples: train_smollm {res['steps']} steps, "
              f"{res['restarts']} restarts, improved={res['improved']}")
        launched("train_smollm", res["launches"], FLASH_AND_NORM)
        steps_s = res["step_seconds"][1:]
        res["tokens_per_s"] = res["tokens_per_step"] / float(np.median(steps_s))
        return {k: v for k, v in res.items() if k not in ("losses", "ckpt_dir")}

    def quickstart():
        zero_lm_counts()
        res = load_example("quickstart_torch").main([])
        torch.cuda.synchronize()
        res["launches"] = lm_counts()
        losses = res["losses"]
        check(all(math.isfinite(x) for x in losses)
              and np.mean(losses[-10:]) < np.mean(losses[:10]) - 1.0,
              f"examples: quickstart loss {losses[0]} -> {losses[-1]}")
        check(1 <= res["steps"] <= 48, f"examples: quickstart {res['steps']} new tokens")
        launched("quickstart", res["launches"], FLASH_AND_NORM)
        return {k: v for k, v in res.items() if k not in ("losses", "tokens")}

    def pipeline():
        done = subprocess.run(
            [sys.executable, "-c", PIPELINE_RUNNER, str(EXAMPLES / "pipeline_lm_torch.py")],
            capture_output=True, text=True, timeout=PIPELINE_SECONDS)
        print(done.stdout, end="", flush=True)
        if done.returncode != 0:
            raise RuntimeError(f"pipeline_lm exited {done.returncode}:\n"
                               f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
        res = json.loads(next(line[len("RESULT "):] for line in done.stdout.splitlines()
                              if line.startswith("RESULT ")))
        ranks = {}
        for line in done.stdout.splitlines():
            m = re.fullmatch(r"launches rank=(\d+) forward=(\{.*?\}) grad=(\{.*\})", line)
            if m:
                ranks[int(m[1])] = {"forward": json.loads(m[2]), "grad": json.loads(m[3])}
        check(sorted(ranks) == list(range(4)), f"examples: pipeline_lm launch lines {ranks}")
        for rank, counts in ranks.items():
            launched(f"pipeline_lm rank {rank} forward", counts["forward"],
                     ("flash_fwd", "rmsnorm"))
            launched(f"pipeline_lm rank {rank} gradient", counts["grad"], FLASH_AND_NORM)
        check(res["max_err"] < 1e-2 and res["grad_err"] < 1e-2,
              f"examples: pipeline_lm max_err {res['max_err']}, grad_err {res['grad_err']}")
        res["launches"] = {k: sum(c[p][k] for c in ranks.values() for p in ("forward", "grad"))
                           for k in FLASH_AND_NORM}
        return res

    for name, fn in (("heterogeneous_stream", hetero), ("partition_explore", explore),
                     ("serve_decode", serve), ("train_smollm", train),
                     ("quickstart", quickstart), ("pipeline_lm", pipeline)):
        run_example(name, fn, out)

    print(f"  examples on {card}:", flush=True)
    r = out["heterogeneous_stream"]
    if r:
        for net in ("Bitonic8", "IDCT8"):
            print(f"    heterogeneous_stream {net}: outputs_match={r[net]['outputs_match']}, "
                  f"host {r[net]['host_ms']:.3f} ms, hetero {r[net]['hetero_ms']:.3f} ms, "
                  f"{r[net]['plink_launches']} PLink launches, stream kernel launches "
                  f"{r['launches']['fused_stream'][net]}", flush=True)
    r = out["partition_explore"]
    if r:
        print(f"    partition_explore: best point hw actors {r['best_hw_actors']} on "
              f"{r['ran_on']}, predicted {r['predicted_ms']:.3f} ms, measured "
              f"{r['measured_ms']:.3f} ms, {r['plink_launches']} PLink launches, stream kernel "
              f"launches {r['launches']['fused_stream']['TopFilter']}, "
              f"outputs_match={r['outputs_match']}",
              flush=True)
    r = out["serve_decode"]
    if r:
        for arch in SERVE_KERNELS:
            a = r[arch]
            print(f"    serve_decode {arch} (published widths): prefill "
                  f"{a['prefill_tok_s']:.1f} tokens/s, decode {a['decode_tok_s']:.1f} tokens/s "
                  f"({a['steps']} steps), launches "
                  f"{ {k: c[arch] for k, c in r['launches'].items()} }", flush=True)
    r = out["train_smollm"]
    if r:
        print(f"    train_smollm (published widths, {r['steps']} steps): loss "
              f"{r['loss_first']:.4f} -> {r['loss_last']:.4f}, {r['restarts']} restart(s), "
              f"improved={r['improved']}, {r['tokens_per_s']:.1f} tokens/s (median step), "
              f"launches {r['launches']}", flush=True)
    r = out["quickstart"]
    if r:
        print(f"    quickstart: loss {r['loss_first']:.4f} -> {r['loss_last']:.4f}, "
              f"{r['steps']} new tokens, launches {r['launches']}", flush=True)
    r = out["pipeline_lm"]
    if r:
        print(f"    pipeline_lm: max_err {r['max_err']:.3e} against the plain sequential "
              f"forward, gradient rel_err {r['grad_err']:.3e} ({r['grad_err_plain']:.3e} "
              f"against the plain one), pipelined forward {r['pipe_ms_median']:.3f} ms "
              f"(host-staged hops, 4 ranks on one card) against sequential "
              f"{r['seq_ms_median']:.3f} ms, "
              f"launches {r['launches']}", flush=True)
    for name, r in out.items():
        if r:
            print(f"    {name}: {r['seconds']:.1f} s", flush=True)
    return out


def build_all(programs) -> None:
    """Build every kernel library at once, one nvcc per source in parallel:
    the five sources of ``csrc/`` and the stream kernel generated for each of
    ``programs``.  A spill in a generated stream kernel fails the run."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.quant import kernel as quant
    from repro_torch.kernels.rmsnorm import kernel as rms
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.stream_fused import kernel as stream

    mods = (flash, rms, ssd, gmm, quant)
    jobs = [(mod.LIBRARY.source.name, mod.LIBRARY.build) for mod in mods]
    compiled = {}

    def gen(name, prog):
        compiled[name] = stream.compile_program(prog, "cuda:0")

    jobs += [(f"stream[{name}]", lambda n=name, p=prog: gen(n, p))
             for name, prog in programs.items()]
    errors = []

    def run(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — reported below, fails the run
            errors.append(f"{name}: {e}")

    threads = [threading.Thread(target=run, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("kernel build failed: " + "; ".join(errors))
    for mod in mods:
        print(f"  {mod.LIBRARY.source.name}: nvcc build {mod.LIBRARY.seconds}s", flush=True)
        for line in mod.LIBRARY.log.strip().splitlines():
            print(f"    {line.strip()}", flush=True)
    seconds = {lib: t1 - t0 for t0, t1, lib in stream.BUILDS}  # plan, emit, nvcc, load
    for name, c in compiled.items():
        pl = c.plan
        print(f"  stream[{name}] -> {c.library}.cu: {len(pl.steps)} ops, perm scope "
              f"{'block' if pl.block_scope else 'warp' if pl.span else 'none'}, "
              f"{pl.k_big} groups a thread at large N; built in {seconds[c.library]:.2f}s",
              flush=True)
        check_ptxas(stream.LIBRARIES[c.library].log, "stream_fused_kernel", lambda fn: True)


def timed(phase, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"  [{phase.__name__}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(SRC))
    from repro_torch.apps.streams import NETWORKS

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in IEEE float32
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"phase 1: build; card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    programs = {"demo": demo_program(), **network_programs(NETWORKS),
                "perm24": perm24_program()}
    ties = ties_program()
    build_all({**programs, "ties": ties})

    rows = timed(phase_kernel, programs, ties)
    launches = timed(phase_e2e, NETWORKS)
    flash_rows = timed(phase_flash)
    train = timed(phase_train)
    norm_rows, ssd_rows, ssd_bwd_rows = timed(phase_norm_ssd)
    serve = timed(phase_serve)
    gmm_rows = timed(phase_gmm)
    moe = timed(phase_moe_serve)
    torch.cuda.empty_cache()  # phase 10's largest input and plain version take ~25 GB
    quant_rows = timed(phase_quant)
    compress = timed(phase_compress)
    torch.cuda.empty_cache()
    explore = timed(phase_explore, NETWORKS, card)
    stream_serve = timed(phase_stream_serve, NETWORKS)
    train_kernels = timed(phase_train_kernels)
    torch.cuda.empty_cache()
    sharded = timed(phase_sharded)
    torch.cuda.empty_cache()
    timed(phase_dryrun)
    torch.cuda.empty_cache()
    examples = timed(phase_examples, card)
    print(f"chip_smoke: 17 phases in {time.perf_counter() - t_start:.1f} s", flush=True)

    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", flush=True)
        return 1
    record = {"kernels": []}

    def example_launches(kernel: str, net: str = "") -> dict:
        """Phase 17's launches of ``kernel`` by twin: a count, or counts by
        sub-run (architecture, network); with ``net``, that network's only."""
        per = {name: res["launches"].get(kernel) for name, res in examples.items()}
        if net:
            per = {name: (c or {}).get(net) for name, c in per.items()}
        per = {name: {k: v for k, v in c.items() if v} if isinstance(c, dict) else c
               for name, c in per.items()}
        return {name: c for name, c in per.items() if c}

    for name in FUSED_NETS:
        row = rows[(name, "main")]
        record["kernels"].append(dict(
            name=f"fused_stream[{name}]", route="cuda",
            source="src/repro_torch/csrc/stream_fused.cuh",
            generator="src/repro_torch/kernels/stream_fused/kernel.py",
            replaces="src/repro/kernels/stream_fused/kernel.py:74",
            launches=launches[name], max_abs_err=max(
                rows[(name, s)]["max_abs_err"] for s in TOKENS
            ),
            ms=row["kernel_ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            ms_by_N={rows[(name, s)]["N"]: rows[(name, s)]["kernel_ms"] for s in TOKENS},
            launches_by_path=dict(
                run=launches[name], explore=explore["launches"].get(name),
                examples=example_launches("fused_stream", name),
                **({"serve_rounds": stream_serve["launches"]} if name == SERVE_NET else {}),
                **({"serve_mixed_rounds": stream_serve["mixed"]["launches"]}
                   if name == "Bitonic8" else {}),
            ),
            design="one generated straight-line kernel per StreamProgram: wires in "
                   "registers, 4 tokens a thread (16-byte loads), parameters as float32 "
                   "bit patterns, matmul8 across a lane pair by shuffles, perm through one "
                   "shared-memory staging",
        ))
    designs = {
        "flash_fwd": "wgmma, TMA tensor maps, mbarrier ring (PR 16)",
        "flash_bwd_dq": "wgmma, TMA tensor maps, mbarrier ring; dS.K reads the K tile "
                        "MN-major (PR 17)",
        "flash_bwd_dkv": "wgmma, TMA tensor maps, mbarrier ring (PR 16); ex2.approx as dQ "
                         "(PR 17)",
        "rmsnorm": "one HBM pass: the row in registers (16-byte vectors, at most 16 a lane), "
                   "1-8 warps a row from norm_plan, blocks keeping scale in registers across "
                   "their rows where it takes at most 64 a lane; rows too wide for 8 warps' "
                   "registers in passes",
        "ssd_scan": "bf16: 3 kernels a call (chunk states (x*s as bf16 hi+lo)^T.B on wgmma, "
                    "float32 state passing, chunk outputs with C.B^T once per head group and "
                    "W.x on wgmma from registers, TMA and an mbarrier ring; W and the entering "
                    "state as bf16 pairs hi+lo in a row's chunks from its first with da > 0); "
                    "f32: one CUDA-core kernel",
        "moe_gmm": "wgmma m64n256k16 (n128 on a last narrow tile), 3-d TMA tensor maps, "
                   "mbarrier ring, a producer warpgroup (PR 17)",
        "quantize_int8": "one block per row, two passes over it (PR 15)",
    }
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
            bound_by=row["bound_by"], library_ms=row["library_ms"], library=row["library"],
            design=designs[name],
            launches_by_path=dict(train=train["launches"][name],
                                  sharded=sharded["launches"][name],
                                  examples=example_launches(name)),
        ))
    def train_path(arch, name, dx=False):
        run = train_kernels[arch]
        per = {"forward": run["one_step"]["cuda"]["forward"][name],
               "backward": run["one_step"]["cuda"]["backward"][name]}
        if dx:
            per["backward_dx"] = run["one_step"]["cuda"]["backward"]["moe_gmm_dx"]
        return dict(arch=arch, layers=run["layers"], run=run["launches"][name], one_step=per)

    for name, rows_, main_shape, path in (
        ("rmsnorm", norm_rows, "prefill768_bf16", "src/repro/kernels/rmsnorm/kernel.py:24"),
        ("ssd_scan", ssd_rows, "path", "src/repro/kernels/ssd_scan/kernel.py:72"),
    ):
        row = rows_[main_shape]
        extra = dict(kernels_per_call=row["kernels_per_call"]) if name == "ssd_scan" else {}
        extra["launches_by_path"] = dict(serve=serve["launches"][name],
                                         sharded=sharded["launches"][name],
                                         examples=example_launches(name))
        if name == "ssd_scan":
            extra["launches_by_path"]["train"] = train_path("mamba2-130m", name)
        record["kernels"].append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=path, launches=serve["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows_.values()),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"], design=designs[name],
            **extra,
        ))
    row = ssd_bwd_rows["path"]
    record["kernels"].append(dict(
        name="ssd_scan_bwd", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="none (JAX differentiates ssd_chunked)",
        launches=train_kernels["mamba2-130m"]["launches"]["ssd_scan_bwd"],
        max_rel_err=max(e for r in ssd_bwd_rows.values() for tag in ("dstate", "no_dstate")
                        for e in r[tag]["rel_err"].values()),
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None, kernels_per_call=len(row["stage_ms"]),
        design="bf16: 5 kernels a call (chunk states and their cotangents as forward stage 1; "
               "the reverse state pass in float32; dx, dB with every head of a batch row in "
               "one block; dC likewise; a_cs's cotangent through the cumsum's reverse to ddt, "
               "dA's parts) on wgmma, TMA and an mbarrier ring; no atomics",
        launches_by_path=dict(train=train_path("mamba2-130m", "ssd_scan_bwd")),
    ))
    row = gmm_rows["prefill"]
    record["kernels"].append(dict(
        name="moe_gmm", route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm/kernel.py:37", launches=moe["launches"]["moe_gmm"],
        max_abs_err=max(r["max_abs_err"] for r in gmm_rows.values()),
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"], design=designs["moe_gmm"],
        launches_by_path=dict(serve=moe["launches"]["moe_gmm"],
                              train=train_path("deepseek-moe-16b", "moe_gmm", dx=True),
                              sharded=dict(forward_backward=sharded["launches"]["moe_gmm"],
                                           dx=sharded["launches"]["moe_gmm_dx"]),
                              examples=example_launches("moe_gmm")),
    ))
    row = quant_rows["embed"]
    record["kernels"].append(dict(
        name="quantize_int8", route="cuda", source="src/repro_torch/csrc/quant.cu",
        replaces="src/repro/kernels/quant/kernel.py:24", launches=compress["launches"],
        max_abs_err=max(r["max_abs_err"] for r in quant_rows.values()),
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"], design=designs["quantize_int8"],
        launches_by_path=dict(compress=compress["launches"],
                              sharded=sharded["launches"]["quantize_int8"]),
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
