"""Architecture config (port copy of the dense-family fields).

The fields of ``repro/configs/base.py::ArchConfig`` that the dense
serving path reads, with the same names and defaults.  Families and
features outside this slice (MoE, recurrent, enc-dec, relu2 MLPs) are
rejected by the model code, not silently ignored.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # only "dense" is served by the port
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    n_experts: int = 0           # MoE is not in this slice
    qk_norm: bool = False
    mlp_kind: str = "swiglu"
    rope_theta: float = 10_000.0
    compute_dtype: str = "bfloat16"  # params are stored in it (the
                                     # reference keeps f32, casts per use)

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
