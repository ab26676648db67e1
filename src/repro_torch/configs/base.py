"""Architecture and shape configs (port copy of the fields it reads).

The fields of ``repro/configs/base.py::ArchConfig`` that the serving
and training paths of the dense, rwkv6, mamba2, hybrid (zamba2) and
enc-dec (whisper) families read, with the same names and defaults, the
parameter count ``n_params`` and ``ShapeConfig``/``SHAPES``.
The reference's sharding and scan knobs (``constrain`` axes,
``unroll_layers``) have no counterpart: the port runs on one device and
loops over layers in Python.  Families and features outside the port
(MoE, relu2 MLPs, vision patches) are rejected by the model code, not
silently ignored.  The reference's ``frontend`` field is not copied:
nothing reads it (its data pipeline picks an audio batch's ``frames``
by family, as ``model_zoo.input_specs`` does here).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm (rwkv6) | mamba (mamba2) |
                                 # hybrid (zamba2) | audio (whisper);
                                 # each serves, and dense, ssm and mamba
                                 # train on the card
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
    # Mamba-2 (family "mamba")
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # Hybrid (family "hybrid"): the shared attention block runs after
    # every ``attn_every`` mamba layers.
    attn_every: int = 0
    # RWKV (family "ssm")
    rwkv_head_dim: int = 64
    # Enc-dec (family "audio", whisper): > 0 => encoder-decoder backbone.
    n_enc_layers: int = 0
    # Numerics / memory.  Serving stores params in ``compute_dtype`` (the
    # reference keeps f32 and casts per use: the same bits, half the
    # memory); training keeps ``param_dtype`` masters and casts them once
    # per loss evaluation.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = ""       # "" => legacy `remat` flag; full|dots|none
    cast_params_once: bool = False  # the port's loss always casts once
    scores_dtype: str = "float32"   # attention logits dtype
    loss_chunk: int = 2048       # chunked cross-entropy (memory cap)
    q_chunk: int = 1024          # query rows per attention backward chunk
    microbatch: int = 0          # >1: grad-accumulation microbatches

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def n_params(self) -> float:
        """Total parameter count (embedding + blocks + head) of the
        attention families, the reference's formula: the vocab unpadded,
        the final norm not counted, the attention norms counted per
        block, an enc-dec's encoder and cross-attention included.  The
        other families' terms are not ported: count their
        ``model_defs``."""
        if self.n_experts or self.family not in ("dense", "audio"):
            raise NotImplementedError(
                f"{self.name}: the parameter count of family "
                f"{self.family!r} (n_experts {self.n_experts}) is not "
                f"ported; sum the shapes of its model_defs")
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = 2 * V * d  # untied in/out
        total = L * (_attn_params(self) + _mlp_params(self))
        if self.is_encdec:
            enc = self.n_enc_layers * (_attn_params(self) + _mlp_params(self))
            dec_cross = self.n_layers * _attn_params(self)  # cross-attn
            total = total + enc + dec_cross
        return emb + total


def _attn_params(c: ArchConfig) -> float:
    dh = c.head_dim
    return (
        c.d_model * c.n_heads * dh            # q
        + 2 * c.d_model * c.n_kv_heads * dh   # k, v
        + c.n_heads * dh * c.d_model          # o
        + 2 * c.d_model                       # norms
    )


def _mlp_params(c: ArchConfig) -> float:
    return 3 * c.d_model * c.d_ff             # swiglu


# ---------------------------------------------------------------------------
# Input shapes (LM shapes: seq_len x global_batch), as in the reference.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
