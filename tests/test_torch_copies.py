"""Copy drift: the framework-neutral modules the PyTorch port keeps as copies
must equal their ``src/repro/`` originals after the ``repro`` ->
``repro_torch`` rename, except for the edits listed here per file.

The port cannot import these modules from ``repro`` (``import repro`` loads
JAX), so it copies them; this test makes any change to a copy, or to its
original, visible.
"""

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
}

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
