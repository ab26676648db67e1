"""mamba2-2.7b [mamba]: pure SSD stack, 64L d_model=2560, head_dim=64,
ssm_state=128, expand=2 — attention-free.
[arXiv:2405.21060; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="mamba2-2.7b", family="mamba",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50_288,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        FULL, n_layers=4, d_model=64, vocab=256,
        ssm_state=16, ssm_head_dim=32,
        q_chunk=32, loss_chunk=32, remat=False)
