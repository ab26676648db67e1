from repro_torch.kernels.mamba2_ssd.ops import ssd  # noqa: F401
