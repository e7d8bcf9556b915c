"""Unified CAL-style frontend: author -> compile -> run -> repartition.

This package is the one road into the compiler: ``@actor``/``@action`` author
dataflow actors declaratively, ``network()`` wires them through typed port
handles, and ``compile()`` turns any network + XCF into an executable
``Program``.  See ``docs/frontend.md`` for the full loop.
"""

from repro_torch.frontend.dsl import (
    ActorHandle,
    FrontendError,
    Network,
    PortHandle,
    action,
    actor,
    network,
)
from repro_torch.frontend.program import (
    BACKENDS,
    Program,
    RunReport,
    compile,
    synthesize_xcf,
)

__all__ = [
    "ActorHandle",
    "BACKENDS",
    "FrontendError",
    "Network",
    "PortHandle",
    "Program",
    "RunReport",
    "action",
    "actor",
    "compile",
    "network",
    "synthesize_xcf",
]
