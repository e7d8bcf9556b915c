"""Compiler middle-end: typed dataflow IR + pass pipeline.

``lower(net_or_graph, xcf) -> IRModule`` runs the default pipeline; the
host scheduler, the device code generator, and PLink all consume the lowered
module instead of raw ``ActorGraph``s.  See ``docs/compiler.md``.
"""

from repro_torch.ir.ir import (  # noqa: F401
    IRActor,
    IRChannel,
    IRModule,
    RateSig,
    Region,
)
from repro_torch.ir.passes import (  # noqa: F401
    Pass,
    PassContext,
    PassPipeline,
    default_pipeline,
    device_dtype_ok,
    legalize_xcf,
    lower,
)

__all__ = [
    "IRActor",
    "IRChannel",
    "IRModule",
    "RateSig",
    "Region",
    "Pass",
    "PassContext",
    "PassPipeline",
    "default_pipeline",
    "device_dtype_ok",
    "legalize_xcf",
    "lower",
]
