"""repro_torch — the PyTorch port of ``repro``, a StreamBlocks-style compiler
for heterogeneous dataflow computing, running its device partitions on an
NVIDIA GPU.

Public surface (the frontend), as in ``repro``:

    import repro_torch

    net = repro_torch.network("TopFilter")       # author (repro_torch.frontend)
    ...
    prog = repro_torch.compile(net, xcf=None)    # device=None means cuda:0
    prog.run()                                   # host / device / mixed, from XCF
    prog.repartition(other_xcf).run()            # re-placement, no graph rebuild

The port imports nothing of ``repro``: the framework-neutral modules are kept
as copies (``tests/test_torch_copies.py`` pins each to its original), and
the device path — fusion codegen, device programs, PLink, the stream kernel
(``repro_torch.kernels.stream_fused``, CUDA C++ in ``csrc/``) — is ported.

LM training of dense models runs through ``repro_torch.launch.train.
run_training`` (device=None means cuda:0), with flash attention forward and
backward as CUDA kernels (``repro_torch.kernels.flash_attention``).
"""

from repro_torch.frontend import (
    FrontendError,
    Network,
    Program,
    RunReport,
    action,
    actor,
    compile,
    network,
    synthesize_xcf,
)

__all__ = [
    "FrontendError",
    "Network",
    "Program",
    "RunReport",
    "action",
    "actor",
    "compile",
    "network",
    "synthesize_xcf",
]
