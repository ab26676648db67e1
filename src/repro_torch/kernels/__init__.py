"""Hand-written Hopper kernels of the port, one package per kernel, each
with its plain-PyTorch ``ref`` beside it.

``SOURCES`` lists every kernel's CUDA sources so a caller can build them
all at once (``_build.build_all(SOURCES)``) before first use.
"""

from repro_torch.kernels.flash_attention.kernel import MMA_SOURCES as _MMA
from repro_torch.kernels.flash_attention.kernel import SOURCES as _FLASH
from repro_torch.kernels.mamba2_ssd.kernel import \
    CHUNK_SOURCES as _SSD_CHUNK
from repro_torch.kernels.mamba2_ssd.kernel import SOURCES as _SSD
from repro_torch.kernels.paged_attention.kernel import SOURCES as _PAGED
from repro_torch.kernels.paged_attention.kernel import \
    SPLIT_SOURCES as _SPLIT
from repro_torch.kernels.rwkv6_wkv.kernel import \
    CHUNK_SOURCES as _WKV_CHUNK
from repro_torch.kernels.rwkv6_wkv.kernel import SOURCES as _WKV
from repro_torch.kernels.tiled_matmul.kernel import SOURCES as _MATMUL
from repro_torch.kernels.tiled_matmul.kernel import \
    TF32X3_SOURCES as _TF32X3
from repro_torch.kernels.tiled_matmul.kernel import \
    WGMMA_SOURCES as _WGMMA

SOURCES = {
    "paged_attention": _PAGED,
    "paged_attention_split": _SPLIT,
    "flash_attention": _FLASH,
    "flash_attention_mma": _MMA,
    "rwkv6_wkv": _WKV,
    "rwkv6_wkv_chunk": _WKV_CHUNK,
    "mamba2_ssd": _SSD,
    "mamba2_ssd_chunk": _SSD_CHUNK,
    "tiled_matmul": _MATMUL,
    "tiled_matmul_wgmma": _WGMMA,
    "tiled_matmul_tf32x3": _TF32X3,
}
