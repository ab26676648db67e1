"""Plain PyTorch versions of kernels B6 and B7, the blocked matmul of the
paper's Fig. 4 ladder, beside the oracle.

``matmul_ref`` is the oracle of ``repro/kernels/tiled_matmul/ref.py``:
a @ b with f32 output, the products of the operands' values summed in
f32 (exact for bf16 operands: a bf16 x bf16 product fits an f32).  It is
also B7's plain version, which takes its operands as given.

``matmul_tiled_ref`` is B6's plain version: the same products, summed
over K in ``bk``-wide blocks in order into an f32 accumulator, as
``_matmul_kernel_acc`` carries its sum across the K grid axis.  The
ladder's dtype policy is applied by ``ops.matmul`` before either runs:
f32 operands at O1-O4, bf16 at O5.
"""

from __future__ import annotations

import torch


def matmul_ref(a, b):
    """a (M, K) @ b (K, N) -> (M, N) float32."""
    return a.float() @ b.float()


def matmul_tiled_ref(a, b, *, bk: int):
    """a (M, K) @ b (K, N) -> (M, N) float32, K walked in ``bk`` blocks
    (``bk`` divides K)."""
    M, K = a.shape
    out = torch.zeros((M, b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        out += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return out
