"""Copy drift: the framework-neutral modules the PyTorch port keeps as copies
must equal their ``src/repro/`` originals after the ``repro`` ->
``repro_torch`` rename, except for the edits listed here per file.

The port cannot import these modules from ``repro`` (``import repro`` loads
JAX), so it copies them; this test makes any change to a copy, or to its
original, visible.
"""

import ast
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

# file -> [(original text after the rename, text in the copy)]
EDITS = {
    "ir/ir.py": [
        (
            'handed to per-platform code generators.\n"""',
            "handed to per-platform code generators.\n\nCopy of "
            "``repro/ir/ir.py``.  Edit: the fused-actor ``codegen`` tags "
            "read\n``\"cuda\" | \"torch\"`` (the reference's ``\"pallas\" | "
            "\"jnp\"``).\n\"\"\"",
        ),
        ('# fused actors: "pallas" | "jnp"', '# fused actors: "cuda" | "torch"'),
    ],
    "ir/passes.py": [
        (
            '``Program.ir_dump()`` renders it.\n"""',
            "``Program.ir_dump()`` renders it.\n\nCopy of "
            "``repro/ir/passes.py``.  Edits: the two docstrings that name "
            "the\nfused codegen say CUDA stream kernel / composed torch where "
            "the reference\nsays Pallas / composed-jnp.\n\"\"\"",
        ),
        (
            "(Pallas stream kernel when specs allow, composed-jnp\n",
            "(CUDA stream kernel when specs allow, composed torch\n",
        ),
        (
            "Codegen is the Pallas stream kernel when every member carries a\n"
            "    ``stream_op`` spec, else a composed-jnp ``vector_fire``.",
            "Codegen is the CUDA stream kernel when every member carries a\n"
            "    ``stream_op`` spec, else a composed torch ``vector_fire``.",
        ),
    ],
    "configs/base.py": [
        (
            '(hybrid interleave, MoE routing, GQA ratios, qk-norm, frontends, ...).\n"""',
            "(hybrid interleave, MoE routing, GQA ratios, qk-norm, frontends, ...).\n\n"
            "Copy of ``repro/configs/base.py``.  Edit: the execution-policy field\n"
            "``use_pallas`` (\"off\" | \"interpret\" | \"tpu\") is ``use_kernels`` here\n"
            "(\"off\" | \"cuda\", default \"cuda\").\n\"\"\"",
        ),
        (
            '    use_pallas: str = "off"  # "off" (pure jnp, used by the CPU dry-run) |\n'
            '    #   "interpret" (Pallas kernels in interpret mode — CPU tests) |\n'
            '    #   "tpu" (compiled kernels; wrap the step in shard_map on a real mesh)\n',
            '    use_kernels: str = "cuda"  # "off" (plain chunked torch attention) |\n'
            '    #   "cuda" (the hand-written CUDA kernels on CUDA tensors; their plain\n'
            '    #   PyTorch versions on CPU tensors — the CPU tests)\n',
        ),
    ],
    "serve_stream/engine.py": [
        (
            "notified by ``submit``/``close``/``stop`` — a parked server burns no core.\n\"\"\"",
            "notified by ``submit``/``close``/``stop`` — a parked server burns no core.\n\n"
            "Copy of ``repro/serve_stream/engine.py``.  Edit: ``_degrade`` never moves\n"
            "a partition on a CUDA device to the host — a launch or retire that fails\n"
            "there fails the partition's live sessions loudly instead.\n\"\"\"",
        ),
        (
            "        if pid in self._quarantined:\n            return\n"
            "        self._quarantined.add(pid)\n",
            "        if pid in self._quarantined:\n            return\n"
            "        device = self._batchers[pid].program.device\n"
            "        if device.type == \"cuda\":\n"
            "            # the partition's tensors live on the card: the host placement\n"
            "            # would compute what the card was asked to, so fail its live\n"
            "            # sessions instead of serving them somewhere else\n"
            "            with self._lock:\n"
            "                sessions = list(self._sessions)\n"
            "            for s in sessions:\n"
            "                if s.pipeline is not None and pid in s.pipeline.stages:\n"
            "                    self._fail_session(\n"
            "                        s, exc, f\"device launch on partition {pid!r} ({device})\"\n"
            "                    )\n"
            "            return\n"
            "        self._quarantined.add(pid)\n",
        ),
    ],
    "serve_stream/session.py": [
        (
            "``Program.run()`` over the same input stream.\n\"\"\"",
            "``Program.run()`` over the same input stream.\n\nCopy of "
            "``repro/serve_stream/session.py``.  Edits: ``DeviceStage`` stages\n"
            "numpy buffers in the numpy form of the port's staging dtype\n"
            "(``runtime/plink.py::_host_dtype``; bfloat16, which numpy lacks, as\n"
            "float32), and the batcher hands them to the device as torch tensors.\n"
            "\"\"\"",
        ),
        ("import numpy as np\n\nfrom", "import numpy as np\nimport torch\n\nfrom"),
        (
            "from repro_torch.runtime.plink import _np_dtype\n",
            "from repro_torch.runtime.plink import _host_dtype\n\n\n"
            "def _np_dtype(dt: str) -> np.dtype:\n"
            '    """The numpy dtype a boundary port stages in on the host."""\n'
            "    t = _host_dtype(dt)\n"
            "    if t == torch.bfloat16:\n"
            "        return np.dtype(np.float32)\n"
            "    return torch.empty(0, dtype=t).numpy().dtype\n",
        ),
        (
            "(``pack_lanes`` stacks, the\n"
            "        # sequential path ``jnp.asarray``s) inside",
            "(``pack_lanes`` stacks them into\n"
            "        # fresh host tensors for both modes) inside",
        ),
    ],
}

CONFIGS = sorted(
    p.name for p in (SRC / "repro" / "configs").glob("*.py")
    if p.name not in ("__init__.py", "base.py")
)

COPIES = [
    "core/__init__.py",
    "core/actor.py",
    "core/graph.py",
    "core/xcf.py",
    "core/actor_machine.py",
    "frontend/dsl.py",
    "ir/__init__.py",
    "ir/ir.py",
    "ir/passes.py",
    "analysis/__init__.py",
    "analysis/diagnostics.py",
    "analysis/rates.py",
    "analysis/deadlock.py",
    "analysis/lints.py",
    "runtime/fifo.py",
    "runtime/sanitizer.py",
    "runtime/stall.py",
    "runtime/chaos.py",
    "runtime/host_fused.py",
    "observability/__init__.py",
    "observability/recorder.py",
    "observability/chrome.py",
    "observability/trace_profile.py",
    "observability/metrics.py",
    "configs/__init__.py",
    "configs/base.py",
    *(f"configs/{name}" for name in CONFIGS),
    "paramdef.py",
    "data/pipeline.py",
    "data/tokenizer.py",
    "distributed/fault.py",
    "core/cost_model.py",
    "core/milp.py",
    "core/partitioner.py",
    "analysis/__main__.py",
    "serve_stream/__init__.py",
    "serve_stream/admission.py",
    "serve_stream/telemetry.py",
    "serve_stream/repartition.py",
    "serve_stream/engine.py",
    "serve_stream/session.py",
]

# ``core/profiler.py`` is a port: these functions in it are copies
PROFILER_COPIES = [
    "profile_host",
    "profile_host_fused",
    "fit_link_model",
    "measure_fifo_bandwidth",
    "profile_from_telemetry",
    "profile_from_trace",
]


def _expected(rel: str) -> str:
    text = re.sub(r"\brepro\b", "repro_torch", (SRC / "repro" / rel).read_text())
    for old, new in EDITS.get(rel, []):
        assert text.count(old) == 1, f"{rel}: listed edit no longer applies: {old!r}"
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_original(rel):
    assert (SRC / "repro_torch" / rel).read_text() == _expected(rel), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: port the "
        f"change, or list the edit in EDITS"
    )


def _function_source(path: Path, name: str) -> str:
    text = path.read_text()
    (node,) = [n for n in ast.parse(text).body
               if isinstance(n, ast.FunctionDef) and n.name == name]
    return ast.get_source_segment(text, node)


# ``distributed/sharding.py`` and ``distributed/pipeline.py`` are ports:
# these functions in them are copies; function -> [(original, copy)] edits
SHARDING_COPIES = ["make_rules", "full_dp_rules", "_resolve", "make_pspec"]
SHARDING_EDITS = {
    # a DeviceMesh names its axes ``mesh_dim_names``; ``axis_names`` reads both kinds
    "_resolve": [("t in mesh.axis_names", "t in axis_names(mesh)")],
}


@pytest.mark.parametrize("name", SHARDING_COPIES)
def test_copied_sharding_function_matches_original(name):
    want = re.sub(r"\brepro\b", "repro_torch",
                  _function_source(SRC / "repro/distributed/sharding.py", name))
    for old, new in SHARDING_EDITS.get(name, []):
        assert want.count(old) == 1, f"{name}: listed edit no longer applies: {old!r}"
        want = want.replace(old, new)
    assert _function_source(SRC / "repro_torch/distributed/sharding.py", name) == want


def _assignment_source(path: Path, name: str) -> str:
    text = path.read_text()
    (node,) = [n for n in ast.parse(text).body if isinstance(n, ast.AnnAssign)
               and getattr(n.target, "id", None) == name]
    return ast.get_source_segment(text, node)


def test_copied_base_rules_match_original():
    """``BASE_RULES`` with its comments, line for line."""
    orig = (SRC / "repro/distributed/sharding.py").read_text()
    port = (SRC / "repro_torch/distributed/sharding.py").read_text()
    start, end = "BASE_RULES: Rules = {", "\n}\n"
    block = lambda t: t[t.index(start):t.index(end, t.index(start))]  # noqa: E731
    assert block(port) == block(orig)
    assert _assignment_source(SRC / "repro_torch/distributed/sharding.py", "BASE_RULES") == \
        _assignment_source(SRC / "repro/distributed/sharding.py", "BASE_RULES")


def test_copied_pipeline_bubble_fraction_matches_original():
    assert _function_source(SRC / "repro_torch/distributed/pipeline.py",
                            "pipeline_bubble_fraction") == _function_source(
        SRC / "repro/distributed/pipeline.py", "pipeline_bubble_fraction")


@pytest.mark.parametrize("name", PROFILER_COPIES)
def test_copied_profiler_function_matches_original(name):
    orig = _function_source(SRC / "repro/core/profiler.py", name)
    port = _function_source(SRC / "repro_torch/core/profiler.py", name)
    assert port == re.sub(r"\brepro\b", "repro_torch", orig)


def test_copied_fused_stream_np_matches_original():
    """``kernels/stream_fused/ref.py`` carries the host evaluator
    (``apply_op_np``/``fused_stream_np``) as a verbatim copy."""
    marker = "# Host (numpy / float64) evaluator"
    orig = (SRC / "repro/kernels/stream_fused/ref.py").read_text()
    port = (SRC / "repro_torch/kernels/stream_fused/ref.py").read_text()
    assert port[port.index(marker):] == orig[orig.index(marker):]


def test_copied_stream_program_matches_original():
    """``ops.py`` keeps ``StreamOp``/``StreamProgram``/``block_unit`` and
    ``fold`` verbatim."""
    orig = (SRC / "repro/kernels/stream_fused/ops.py").read_text()
    port = (SRC / "repro_torch/kernels/stream_fused/ops.py").read_text()
    for start, end in (
        ("OP_KINDS = (", "def _on_cpu()"),
        ("# Algebraic folding", None),
    ):
        a = orig.index(start)
        piece = orig[a:orig.index(end, a)] if end else orig[a:]
        assert piece.rstrip() and piece.rstrip() in port


def test_port_imports_nothing_of_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ml_dtypes|repro)\b(?!_)", re.M)
    files = [*(SRC / "repro_torch").rglob("*.py"), SRC.parent / "chip_smoke.py"]
    for f in files:
        assert not pat.search(f.read_text()), f
