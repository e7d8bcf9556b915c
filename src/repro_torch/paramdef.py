"""ParamDef: shape + logical axes + init rule for one parameter leaf.

Lives at top level so both the model layer library and the sharding machinery can
import it without a cycle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02
    dtype: Optional[str] = None  # override param dtype (e.g. f32 for norms)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def is_paramdef(x) -> bool:
    return isinstance(x, ParamDef)
