from repro_torch.kernels.rwkv6_wkv.ops import wkv  # noqa: F401
