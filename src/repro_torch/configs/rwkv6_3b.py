"""rwkv6-3b [ssm] "Finch": 32L d_model=2560, attention-free WKV6 with
data-dependent decay, channel-mix d_ff=8960, vocab=65536.
[arXiv:2404.05892; hf]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab=65_536, rwkv_head_dim=64,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        FULL, n_layers=2, d_model=64, d_ff=128, vocab=256,
        rwkv_head_dim=16, q_chunk=32, loss_chunk=32, remat=False)
