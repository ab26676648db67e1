"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865, enc-dec; conv frontend STUBBED (input_specs supplies frame
embeddings). [arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

FULL = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51_865,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        FULL, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, q_chunk=32,
        loss_chunk=32, remat=False)
