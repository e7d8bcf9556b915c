from repro_torch.kernels.stream_fused.ops import (  # noqa: F401
    StreamOp,
    StreamProgram,
    block_unit,
    fold,
    fused_stream,
)
from repro_torch.kernels.stream_fused.ref import (  # noqa: F401
    fused_stream_np,
    fused_stream_ref,
)
