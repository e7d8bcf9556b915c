"""The fused SDF stream-region kernel on the card: plan, emit, build, launch.

Replaces ``repro/kernels/stream_fused/kernel.py::fused_stream_fwd`` (the
Pallas TPU kernel), whose op list is static at trace time and unrolls into
straight-line vector code.  Here each ``StreamProgram`` becomes its own CUDA
kernel in straight-line code: ``csrc/stream_fused.cuh`` holds the kernel
template and the device helpers, and its header note says what bounds the
kernel and how the design answers that.

* **Plan.**  ``plan(program)`` is a pure function of the program: one
  ``Step`` per op (the C++ local it defines, the locals it reads, its
  parameters as float32 bit patterns, a perm's gather table over its staging
  scope), the perm staging scope (a warp's 128 tokens when every P divides
  128, else the block's), and the groups of 4 tokens a thread takes at
  large N.
* **Emit.**  ``emit(plan)`` writes the kernel's source: a ``Program`` struct
  whose ``run`` has one statement per op, every parameter written as its bit
  pattern (``f32(0x...u)``), ending in the template's entry macro.
* **Build.**  ``compile_program`` writes the source under
  ``repro_torch/build/`` (named by its own hash) and builds it as a
  ``kernels/build.py::Library`` (``nvcc``, ``sm_90a``, ``--fmad=false``):
  the library's name hashes the generated source, the template header and
  the flags, so a built program is loaded, not rebuilt.  The device runtime
  calls it when a partition is compiled
  (``runtime/device_runtime.py::compile_partition``), off ``run()``'s
  clock; a failed build raises.  ``BUILDS`` records every program compiled
  for a device (plan, emit and the library's build or load, its start and
  end on ``time.perf_counter``) and ``LIBRARIES`` each library by name,
  with its ptxas report (``.log``).
* **Launch.**  ``fused_stream_cuda`` checks its inputs, allocates the
  outputs, picks the grid (``launch_shape``: every SM a block at small N,
  groups of K a thread at large N) and launches on
  ``torch.cuda.current_stream()``; any launch error raises.  ``LAUNCHES``
  counts the launches and nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import BUILD_DIR, COMMON_FLAGS, CSRC, Library
from repro_torch.kernels.stream_fused.ops import StreamProgram, block_unit

LAUNCHES = 0
BUILDS: List[Tuple[float, float, str]] = []  # (start, end, library) of every program compiled
LIBRARIES: Dict[str, Library] = {}  # library name -> the generated program's library

TEMPLATE = CSRC / "stream_fused.cuh"
NVCC_FLAGS = (*COMMON_FLAGS, "--fmad=false")

MAX_WIRES = 32     # csrc/stream_fused.cuh MAX_WIRES
WARP_SPAN = 128    # tokens of a warp: 32 lanes x 4
MAX_THREADS = 256  # a block's threads where the perm scope is the warp
MAX_SPAN = 4096    # tokens of a block-scope staging: 1024 threads x 4
LOAD_WORDS = 16    # input floats a thread keeps in flight at large N


def _bits(v) -> int:
    """The float32 bit pattern of ``v`` as PyTorch rounds a Python scalar
    (or takes a float32) into a float32 op."""
    return int(np.asarray(v, np.float64).astype(np.float32).view(np.uint32))


@dataclass(frozen=True)
class Step:
    kind: str                  # the op's kind
    out: str                   # the C++ local it defines
    ins: Tuple[str, ...]       # the locals it reads
    bits: Tuple[int, ...]      # its parameters' float32 bit patterns
    parts: Tuple[str, ...] = ()       # affine: "add"/"mul" for each of bits, in order
    table: Tuple[int, ...] = ()       # perm: staged position each scope position reads


@dataclass(frozen=True)
class Plan:
    n_inputs: int
    steps: Tuple[Step, ...]
    outputs: Tuple[str, ...]   # the local stored to each output wire
    unit: int                  # the program's block unit
    block_scope: bool          # perms stage the block's tokens, else a warp's
    span: int                  # tokens of one staging scope (0: no perm)
    k_big: int                 # groups of 4 tokens a thread takes at large N

    @property
    def threads(self) -> int:
        """A block's threads where the perm scope fixes them, else 0."""
        return self.span // 4 if self.block_scope else 0


def plan(program: StreamProgram) -> Plan:
    """The straight-line kernel ``program`` becomes.  Raises ``ValueError``
    on what the kernel does not take."""
    if not 1 <= program.n_inputs <= MAX_WIRES or not 1 <= len(program.outputs) <= MAX_WIRES:
        raise ValueError(f"stream kernel: at most {MAX_WIRES} input and output wires")
    unit = block_unit(program)
    ps = [len(op.params[0]) for op in program.ops if op.kind == "perm"]
    block_scope = any(WARP_SPAN % p for p in ps)
    span = math.lcm(WARP_SPAN, *ps) if block_scope else (WARP_SPAN if ps else 0)
    if span > MAX_SPAN:
        raise ValueError(
            f"stream kernel: perm blocks {sorted(set(ps))} need a staging scope of "
            f"{span} tokens, above the {MAX_SPAN} one block holds"
        )
    local = {i: f"x{i}" for i in range(program.n_inputs)}
    steps = []
    for k, op in enumerate(program.ops):
        ins = tuple(local[r] for r in op.ins)
        out = f"v{k}"
        if op.kind == "affine":
            pre, mul, post = op.params
            applied = [(p, v) for p, v, keep in (
                ("add", pre, pre != 0.0), ("mul", mul, mul != 1.0), ("add", post, post != 0.0)
            ) if keep]
            step = Step("affine", out, ins, tuple(_bits(v) for _, v in applied),
                        tuple(p for p, _ in applied))
        elif op.kind in ("clip", "axpy", "const"):
            step = Step(op.kind, out, ins, tuple(_bits(v) for v in op.params))
        elif op.kind in ("min2", "max2"):
            step = Step(op.kind, out, ins, ())
        elif op.kind == "matmul8":
            basis = np.asarray(op.params[0], np.float32).reshape(64)
            step = Step("matmul8", out, ins, tuple(int(b) for b in basis.view(np.uint32)))
        elif op.kind == "perm":
            idx = np.asarray(op.params[0], np.int64)
            P = len(idx)
            if sorted(idx.tolist()) != list(range(P)):
                raise ValueError(f"stream kernel: perm index {idx.tolist()} is not a permutation")
            j = np.arange(span)
            step = Step("perm", out, ins, (), table=tuple((j - j % P + idx[j % P]).tolist()))
        else:
            raise ValueError(f"unknown stream op {op.kind!r}")
        steps.append(step)
        local[op.out] = out
    loaded = {n for s in steps for n in s.ins} | {local[r] for r in program.outputs}
    words = 4 * sum(f"x{i}" in loaded for i in range(program.n_inputs))
    k_big = max(1, min(4, LOAD_WORDS // max(words, 1)))
    return Plan(program.n_inputs, tuple(steps), tuple(local[r] for r in program.outputs),
                unit, block_scope, span, k_big)


def _lit(bits: int) -> str:
    return f"f32(0x{bits:08x}u)"


def _statement(s: Step, perm_no: Dict[str, int], block_scope: bool) -> str:
    a = s.ins
    if s.kind == "affine":
        expr = a[0]
        for part, b in zip(s.parts, s.bits):
            expr = f"{part}({expr}, {_lit(b)})"
    elif s.kind == "clip":
        expr = f"clip({a[0]}, {_lit(s.bits[0])}, {_lit(s.bits[1])})"
    elif s.kind == "axpy":
        expr = f"axpy({a[0]}, {a[1]}, {_lit(s.bits[0])})"
    elif s.kind == "const":
        expr = f"splat({_lit(s.bits[0])})"
    elif s.kind in ("min2", "max2"):
        expr = f"{s.kind}({a[0]}, {a[1]})"
    elif s.kind == "matmul8":
        expr = f"matmul8({a[0]}, c, Basis{{{{{', '.join(_lit(b) for b in s.bits)}}}}})"
    else:  # perm
        expr = f"perm<{str(block_scope).lower()}>({a[0]}, c, psrc{perm_no[s.out]}[c.li])"
    return f"    const W {s.out} = {expr};  // {s.kind}"


def emit(p: Plan) -> str:
    """The CUDA source of the plan's kernel."""
    perm_no = {s.out: i for i, s in enumerate(x for x in p.steps if x.kind == "perm")}
    tables = []
    for s in p.steps:
        if s.kind == "perm":
            rows = ", ".join("{" + ", ".join(map(str, s.table[q:q + 4])) + "}"
                             for q in range(0, len(s.table), 4))
            tables.append(f"__device__ const int4 psrc{perm_no[s.out]}[{len(s.table) // 4}] = "
                          f"{{{rows}}};")
    n_out = len(p.outputs)
    max_threads = p.threads or MAX_THREADS
    stage = p.span if p.block_scope else (WARP_SPAN * MAX_THREADS // 32 if p.span else 1)
    lines = [
        "// Generated by repro_torch/kernels/stream_fused/kernel.py from one StreamProgram;",
        "// rebuilt when it or csrc/stream_fused.cuh changes.  One statement per op.",
        '#include "../csrc/stream_fused.cuh"',
        "",
        "namespace {",
        "",
        *tables,
        *([""] if tables else []),
        "struct Program {",
        f"  static constexpr int kIn = {p.n_inputs}, kOut = {n_out}, kK = {p.k_big};",
        f"  static constexpr int kBlockScope = {int(p.block_scope)}, kStage = {stage}, "
        f"kMaxThreads = {max_threads};",
        f"  __device__ static __forceinline__ void run(const W (&in)[{p.n_inputs}], "
        f"W (&out)[{n_out}], const Ctx& c) {{",
        *(f"    const W x{i} = in[{i}];" for i in range(p.n_inputs)),
        *(_statement(s, perm_no, p.block_scope) for s in p.steps),
        *(f"    out[{j}] = {o};" for j, o in enumerate(p.outputs)),
        "  }",
        "};",
        "",
        "}  // namespace",
        "",
        "STREAM_FUSED_ENTRY(Program)",
        "",
    ]
    return "\n".join(lines)


def source_path(source: str):
    """Where the generated ``source`` is written: under the build directory,
    named by its own hash."""
    return BUILD_DIR / f"stream_{hashlib.sha256(source.encode()).hexdigest()[:16]}.cu"


def launch_shape(p: Plan, n: int, sms: int, aligned: bool = True) -> Tuple[int, int, int]:
    """``(k, threads, blocks)`` of the launch over ``n`` tokens a wire on a
    card of ``sms`` SMs: one group of 4 tokens a thread and a block for every
    SM while that leaves a thread no more; groups of ``k_big`` a thread, 256
    threads a block, once the grid holds at least four blocks an SM."""
    groups = n // 4
    k = p.k_big if aligned and groups >= 4 * sms * MAX_THREADS * p.k_big else 1
    if p.threads:
        threads = p.threads
    elif k > 1:
        threads = MAX_THREADS
    else:
        threads = min(MAX_THREADS, max(32, 32 * math.ceil(groups / sms / 32)))
    return k, threads, max(1, math.ceil(groups / (threads * k)))


@dataclass
class _Compiled:
    program: StreamProgram  # held so its id() is never reused while cached
    plan: Plan
    library: str
    launch: object          # the library's stream_fused_launch
    empty: object           # its stream_fused_empty
    sms: int
    shapes: Dict[Tuple[int, bool], Tuple[int, int, int]] = field(default_factory=dict)

    def shape(self, n: int, aligned: bool) -> Tuple[int, int, int]:
        """``launch_shape`` for ``n`` tokens a wire, kept per (n, aligned)."""
        got = self.shapes.get((n, aligned))
        if got is None:
            got = self.shapes[(n, aligned)] = launch_shape(self.plan, n, self.sms, aligned)
        return got


_lock = threading.Lock()
_compiled: Dict[Tuple[int, torch.device], _Compiled] = {}


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.stream_fused_launch.restype = i
    lib.stream_fused_launch.argtypes = [p, i, p, i, ctypes.c_longlong, i, i, i, i, p]
    lib.stream_fused_empty.restype = i
    lib.stream_fused_empty.argtypes = [i, i, p]


def _build(source: str) -> Tuple[ctypes.CDLL, str]:
    path = source_path(source)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not path.exists():
        tmp = path.with_suffix(f".{threading.get_ident()}.tmp")
        tmp.write_text(source)
        tmp.replace(path)
    with _lock:
        library = LIBRARIES.setdefault(path.stem, Library(path, _bind, flags=NVCC_FLAGS))
    return library.build(), path.stem


def compile_program(program: StreamProgram, device) -> _Compiled:
    """Plan, emit, build (or load) and bind ``program``'s kernel for
    ``device``; cached by the program object's identity (formatting a program
    to key it would cost more per launch than the launch itself)."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    key = (id(program), device)
    c = _compiled.get(key)
    if c is not None and c.program is program:
        return c
    t0 = time.perf_counter()
    pl = plan(program)
    lib, library = _build(emit(pl))
    c = _Compiled(
        program=program, plan=pl, library=library, launch=lib.stream_fused_launch,
        empty=lib.stream_fused_empty,
        sms=torch.cuda.get_device_properties(device).multi_processor_count,
    )
    with _lock:
        _compiled[key] = c
        BUILDS.append((t0, time.perf_counter(), library))
    return c


def check_inputs(
    inputs: Sequence[torch.Tensor], program: StreamProgram, unit: int
) -> int:
    """Validate the wires the kernel takes; returns tokens per wire (all
    rows).  Raises ``ValueError`` on what the kernel does not take."""
    if len(inputs) != program.n_inputs:
        raise ValueError(
            f"stream kernel: {len(inputs)} inputs for a program of "
            f"{program.n_inputs}"
        )
    if not 1 <= program.n_inputs <= MAX_WIRES or not 1 <= len(program.outputs) <= MAX_WIRES:
        raise ValueError(f"stream kernel: at most {MAX_WIRES} input and output wires")
    shape = inputs[0].shape
    for x in inputs:
        if x.dtype != torch.float32:
            raise ValueError(f"stream kernel: wires must be float32, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"stream kernel: wire shapes differ ({x.shape} vs {shape})")
        if not x.is_contiguous():
            raise ValueError("stream kernel: wires must be contiguous")
        if x.device != inputs[0].device:
            raise ValueError("stream kernel: wires lie on different devices")
    if len(shape) not in (1, 2):
        raise ValueError(f"stream kernel: wires are (N,) or (B, N), got {tuple(shape)}")
    if shape[-1] % unit:
        raise ValueError(
            f"stream kernel: N={shape[-1]} tokens is not a multiple of the "
            f"program's block unit {unit}"
        )
    return math.prod(shape)


def _device(inputs: Sequence[torch.Tensor], program: StreamProgram) -> torch.device:
    dev = inputs[0].device if inputs else None
    if dev is None or dev.type != "cuda":
        check_inputs(inputs, program, block_unit(program))
        raise ValueError(
            f"stream kernel: wires must be CUDA tensors, got {dev} (the plain "
            f"version is ref.fused_stream_ref)"
        )
    return dev


def fused_stream_cuda(
    inputs: Sequence[torch.Tensor], program: StreamProgram
) -> List[torch.Tensor]:
    """Run ``program`` over CUDA wires in ONE kernel launch; returns the
    output wires, shaped like the inputs."""
    global LAUNCHES
    dev = _device(inputs, program)
    c = compile_program(program, dev)
    n = check_inputs(inputs, program, c.plan.unit)
    out = torch.empty(
        (len(program.outputs),) + tuple(inputs[0].shape),
        dtype=torch.float32, device=dev,
    )
    outs = list(out.unbind(0))
    if n == 0:
        return outs
    in_ptrs = [x.data_ptr() for x in inputs]
    out_ptrs = [o.data_ptr() for o in outs]
    # the outputs are rows of one fresh tensor, N % 8 == 0: 16-byte aligned
    aligned = not any(q & 15 for q in in_ptrs)
    k, threads, blocks = c.shape(n, aligned)
    ins = (ctypes.c_void_p * len(in_ptrs))(*in_ptrs)
    outp = (ctypes.c_void_p * len(out_ptrs))(*out_ptrs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = c.launch(ctypes.addressof(ins), len(in_ptrs), ctypes.addressof(outp),
                       len(out_ptrs), n, k, int(aligned), threads, blocks, stream)
    if err != 0:
        raise RuntimeError(f"stream kernel launch failed: CUDA error {err}")
    with _lock:
        LAUNCHES += 1
    return outs


def empty_launch(inputs: Sequence[torch.Tensor], program: StreamProgram) -> None:
    """Launch an empty kernel on the grid ``fused_stream_cuda`` gives these
    wires: the launch floor its time is read beside (not counted)."""
    dev = _device(inputs, program)
    c = compile_program(program, dev)
    n = check_inputs(inputs, program, c.plan.unit)
    _, threads, blocks = c.shape(n, True)
    with torch.cuda.device(dev):
        err = c.empty(threads, blocks, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream kernel: empty launch failed: CUDA error {err}")
