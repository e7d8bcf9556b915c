"""The kernel build's library name: a hash of the CUDA source, every local
header it includes and the flags, so that an edit to a shared header
(``csrc/hopper.cuh``, the stream kernels' template ``csrc/stream_fused.cuh``)
never reuses a stale library.  No ``nvcc`` is needed: the tag is computed
from the files alone."""

import stat
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.build import CSRC, local_sources, source_tag
from repro_torch.kernels.stream_fused import StreamOp, StreamProgram
from repro_torch.kernels.stream_fused import kernel as stream

FLAGS = ("-O3", "-std=c++17")


def _tree(tmp_path: Path) -> Path:
    (tmp_path / "inc").mkdir()
    (tmp_path / "prims.cuh").write_text('#pragma once\n#include "inc/deep.cuh"\nint prim();\n')
    (tmp_path / "inc" / "deep.cuh").write_text("#pragma once\nint deep();\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda.h>\n#include "prims.cuh"\n  #  include "prims.cuh"\n'
                   "int k() { return prim(); }\n")
    return src


def test_tag_changes_when_an_included_header_changes(tmp_path):
    src = _tree(tmp_path)
    before = source_tag(src, FLAGS)
    assert source_tag(src, FLAGS) == before  # a pure function of the files and flags
    header = tmp_path / "prims.cuh"
    header.write_text(header.read_text() + "int prim2();\n")
    after = source_tag(src, FLAGS)
    assert after != before
    deep = tmp_path / "inc" / "deep.cuh"  # included by the header, not the source
    deep.write_text(deep.read_text() + "int deep2();\n")
    assert source_tag(src, FLAGS) not in (before, after)


def test_tag_changes_with_the_source_and_the_flags(tmp_path):
    src = _tree(tmp_path)
    before = source_tag(src, FLAGS)
    assert source_tag(src, (*FLAGS, "-DTILE=128")) != before
    src.write_text(src.read_text() + "int k2();\n")
    assert source_tag(src, FLAGS) != before


def test_local_sources_follow_quoted_includes_once(tmp_path):
    src = _tree(tmp_path)
    assert [p.name for p in local_sources(src)] == ["k.cu", "prims.cuh", "deep.cuh"]


def test_port_sources_hash_the_shared_hopper_header():
    """The three tensor-core sources include csrc/hopper.cuh, so its edits
    rebuild their libraries; a generated stream kernel includes the
    template csrc/stream_fused.cuh from the build directory."""
    for name in ("flash_attention.cu", "moe_gmm.cu", "ssd_scan.cu"):
        assert [p.name for p in local_sources(CSRC / name)] == [name, "hopper.cuh"]
    for name in ("rmsnorm.cu", "quant.cu"):
        assert [p.name for p in local_sources(CSRC / name)] == [name]
    src = stream.emit(stream.plan(_stream_program(0.25)))
    path = stream.source_path(src)
    assert path.parent == build.BUILD_DIR and path.suffix == ".cu"
    assert f'#include "../{CSRC.name}/stream_fused.cuh"' in src
    assert (path.parent / "../csrc/stream_fused.cuh").resolve() == stream.TEMPLATE


def _stream_program(c: float):
    return StreamProgram(1, 3, (StreamOp("const", (0,), 1, (0.0,)),
                                StreamOp("axpy", (0, 1), 2, (c,))), (2,))


def test_generated_stream_tag_follows_the_template_and_the_program(tmp_path):
    """The library of a generated stream kernel is named by the generated
    source, the template header and the flags: the same program gives the
    same name, another program or an edited template another."""
    (tmp_path / "build").mkdir()
    (tmp_path / "csrc").mkdir()
    header = tmp_path / "csrc" / "stream_fused.cuh"
    header.write_text(stream.TEMPLATE.read_text())

    def tag(program) -> str:
        src = stream.emit(stream.plan(program))
        gen = tmp_path / "build" / stream.source_path(src).name
        gen.write_text(src)
        assert [p.name for p in local_sources(gen)] == [gen.name, "stream_fused.cuh"]
        return source_tag(gen, stream.NVCC_FLAGS)

    before = tag(_stream_program(0.25))
    assert tag(_stream_program(0.25)) == before  # another object, the same program
    assert tag(_stream_program(0.5)) != before
    header.write_text(header.read_text() + "// an edit\n")
    assert tag(_stream_program(0.25)) != before


def test_build_library_renames_report_and_library_into_place(tmp_path, monkeypatch):
    """A stand-in for nvcc writes the library and prints a ptxas report: both
    land under their final names, the report returned with the library, and
    no temporary file is left; a second call builds nothing and returns the
    kept report."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n"
        "sys.stderr.write('ptxas info    : Used 30 registers\\n')\n"
    )
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    src = _tree(tmp_path)
    lib, _, log = build.build_library(src, FLAGS)
    assert "Used 30 registers" in log
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        f"k_{source_tag(src, FLAGS)}.log", f"k_{source_tag(src, FLAGS)}.so"]
    assert lib.endswith(f"k_{source_tag(src, FLAGS)}.so")
    monkeypatch.setattr(build, "nvcc", lambda: "/nonexistent/nvcc")
    assert build.build_library(src, FLAGS)[2] == log


class _FakeLib:
    """What ``ctypes.CDLL`` returns, with an ``init`` entry that answers
    ``err`` and counts its calls."""

    def __init__(self, err=0):
        self.calls = 0
        self.err = err

        def init():
            self.calls += 1
            return self.err

        self.lib_init = init


def test_library_builds_binds_and_inits_once(monkeypatch):
    """``Library`` builds and binds once however often it is asked, keeps the
    build's seconds and report, and runs ``init`` once per device; a failed
    ``init`` raises with the module's name for the library and runs again on
    the next call."""
    import contextlib

    fake, built, bound = _FakeLib(), [], []

    def build_library(source, flags):
        built.append((source, tuple(flags)))
        return fake, 1.5, "ptxas info    : Used 30 registers\n"

    monkeypatch.setattr(build, "build_library", build_library)
    monkeypatch.setattr(build.torch.cuda, "device", lambda idx: contextlib.nullcontext())
    lib = build.Library(CSRC / "quant.cu", bound.append, init="lib_init", what="quant kernel")
    assert lib.build() is fake and lib.build() is fake
    assert built == [(CSRC / "quant.cu", build.COMMON_FLAGS)] and bound == [fake]
    assert lib.seconds == 1.5 and "Used 30 registers" in lib.log and fake.calls == 0
    for _ in range(2):
        assert lib.on(build.torch.device("cuda", 0)) is fake
    assert fake.calls == 1
    lib.on(build.torch.device("cuda", 1))
    assert fake.calls == 2 and len(built) == 1
    fake.err = 3
    for calls in (3, 4):
        with pytest.raises(RuntimeError, match="^quant kernel: lib_init failed: CUDA error 3$"):
            lib.on(build.torch.device("cuda", 2))
        assert fake.calls == calls
    plain = build.Library(CSRC / "rmsnorm.cu", bound.append, flags=("-O3",))
    assert plain.on(build.torch.device("cpu")) is fake and built[-1][1] == ("-O3",)


def _smoke_main():
    import ast

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    text = path.read_text()
    (main,) = [n for n in ast.parse(text).body
               if isinstance(n, ast.FunctionDef) and n.name == "main"]
    return main, text


def test_chip_smoke_main_runs_the_sharded_phase():
    """Phase 15 (``phase_sharded``) is run by ``main()``, timed, after
    phase 14, and its result feeds the kernels line."""
    import ast

    main, text = _smoke_main()
    calls = [ast.get_source_segment(text, n) for n in ast.walk(main)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "timed"]
    phases = [c.split("(", 1)[1].split(",")[0].rstrip(")") for c in calls]
    assert "phase_sharded" in phases
    assert phases.index("phase_sharded") > phases.index("phase_train_kernels")


def test_chip_smoke_kernels_line_names_the_sharded_path():
    """Every ``launches_by_path`` of the flash, RMSNorm, SSD, ``moe_gmm``
    and quantizer entries has a ``sharded`` key fed by phase 15."""
    import ast

    main, text = _smoke_main()
    by_path = [ast.get_source_segment(text, kw.value) for n in ast.walk(main)
               if isinstance(n, ast.Call) for kw in n.keywords if kw.arg == "launches_by_path"]
    by_path += [ast.get_source_segment(text, n.value) for n in ast.walk(main)
                if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Subscript) and getattr(t.slice, "value", None)
                    == "launches_by_path" for t in n.targets)]
    sharded = [seg for seg in by_path if "sharded=" in seg and 'sharded["launches"]' in seg]
    # flash (its three kernels), RMSNorm and the SSD scan (one loop), moe_gmm, quant
    assert len(sharded) == 4, by_path
    loop = [seg for seg in by_path if "serve=serve" in seg]
    assert loop and all('sharded=sharded["launches"][name]' in seg for seg in loop)
    for name in ("moe_gmm", "quantize_int8"):
        assert any(f'sharded["launches"]["{name}"]' in seg for seg in sharded), name


def test_chip_smoke_kernels_line_holds_the_ssd_backward():
    """Phase 6 returns the SSD backward's rows apart from the forward's, so
    that every forward row the kernels line reads is one of its shapes; they
    feed an ``ssd_scan_bwd`` entry whose launches come from phase 14."""
    import ast

    main, text = _smoke_main()
    (phase6,) = [n for n in ast.walk(main) if isinstance(n, ast.Assign)
                 and "phase_norm_ssd" in ast.get_source_segment(text, n.value)]
    assert [ast.get_source_segment(text, t) for t in phase6.targets[0].elts] == [
        "norm_rows", "ssd_rows", "ssd_bwd_rows"]
    (fn,) = [n for n in ast.parse(text).body
             if isinstance(n, ast.FunctionDef) and n.name == "phase_norm_ssd"]
    stores = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)
              and any(isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "ssd_rows"
                      for t in n.targets)]
    assert stores and all(getattr(n.value, "id", None) == "row" for n in stores)
    entries = [n for n in ast.walk(main) if isinstance(n, ast.Call)
               and any(kw.arg == "name" and getattr(kw.value, "value", None) == "ssd_scan_bwd"
                       for kw in n.keywords)]
    assert len(entries) == 1
    seg = ast.get_source_segment(text, entries[0])
    assert 'train_path("mamba2-130m", "ssd_scan_bwd")' in seg and "ssd_bwd_rows" in seg
