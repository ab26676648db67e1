from repro_torch.kernels.tiled_matmul.ops import matmul  # noqa: F401
