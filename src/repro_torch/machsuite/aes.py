"""AES-256 ECB — the paper's Fig. 2/4 walkthrough kernel (port of
``repro/machsuite/aes.py``).

Table 3: 256-bit key, 64 MB data.  The level ladder is the paper's code
walk (Fig. 4a-d), each level the reference's structure in eager PyTorch:

  O0  block-at-a-time against the full buffer (a slice per block, the
      naive per-access DRAM architecture of Fig. 2), SubBytes a lane loop
  O1  batch staging: 1 KB slabs in turn, blocks still one at a time
  O2  + each block's 16 byte-lanes vectorised; blocks in turn (the scan)
  O3  + the blocks of a slab encrypted at once, PE_NUM as a batch dim
  O4  + explicit 3-slot load/compute/store rotation (Fig. 4c)
  O5  + slabs staged as packed 32-bit words (Fig. 4d)

O0 and O1 issue a few tensor operations per byte and round, as the
reference's loops do: meant for the tests' scales (2 KB), not 64 MB.

The S-box is *derived* (GF(2^8) inverse + affine), not transcribed, and
the whole cipher is pinned by the FIPS-197 appendix C.3 test vector in
the tests.  Table lookups index with ``int64``: a ``uint8`` index tensor
is taken as a boolean mask.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import (OptLevel, pack_u8_to_u32, rotate3,
                                          unpack_u32_to_u8)

PROFILE = MACHSUITE_PROFILES["aes"]

N_ROUNDS = 14                      # AES-256
BLOCK = 16
BATCH_BLOCKS = 64                  # paper BATCH_SIZE = 1 KB slabs
BATCH_BYTES = BATCH_BLOCKS * BLOCK
PE_NUM = 8                         # paper Fig. 4(b) duplication factor
# the reference tests' scale (2,048 bytes): the port's tests and the
# card's check in chip_smoke.py run every level at it
TEST_SCALE = 2048 / 64e6


# ---------------------------------------------------------------------------
# Tables (host-side, derived from first principles)
# ---------------------------------------------------------------------------

def _gf_mul(a: int, b: int) -> int:
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return p


def _make_sbox() -> np.ndarray:
    inv = np.zeros(256, np.uint8)
    for x in range(1, 256):
        for y in range(1, 256):
            if _gf_mul(x, y) == 1:
                inv[x] = y
                break
    rotl = lambda v, n: ((v << n) | (v >> (8 - n))) & 0xFF
    sbox = np.zeros(256, np.uint8)
    for x in range(256):
        b = int(inv[x])
        sbox[x] = b ^ rotl(b, 1) ^ rotl(b, 2) ^ rotl(b, 3) ^ rotl(b, 4) ^ 0x63
    return sbox


SBOX = _make_sbox()

# ShiftRows on the FIPS state layout (flat index = r + 4c):
# out[r + 4c] = in[r + 4*((c + r) % 4)]
SHIFT_PERM = np.array(
    [r + 4 * ((c + r) % 4) for c in range(4) for r in range(4)], np.int32
)


def expand_key(key: np.ndarray) -> np.ndarray:
    """FIPS-197 key expansion for AES-256 -> (15, 16) round keys (uint8)."""
    key = np.asarray(key, np.uint8)
    assert key.shape == (32,), key.shape
    Nk, Nr = 8, N_ROUNDS
    w = np.zeros((4 * (Nr + 1), 4), np.uint8)
    w[:Nk] = key.reshape(Nk, 4)
    rcon = 1
    for i in range(Nk, 4 * (Nr + 1)):
        t = w[i - 1].copy()
        if i % Nk == 0:
            t = np.roll(t, -1)
            t = SBOX[t]
            t[0] ^= rcon
            rcon = _gf_mul(rcon, 2)
        elif i % Nk == 4:
            t = SBOX[t]
        w[i] = w[i - Nk] ^ t
    return w.reshape(Nr + 1, 16)


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def _xtime_np(x):
    return (((x.astype(np.uint16) << 1) & 0xFF)
            ^ (((x >> 7) & 1) * 0x1B)).astype(np.uint8)


def _mix_columns_np(s):
    """s: (..., 16) uint8, columns are consecutive 4-byte groups."""
    c = s.reshape(*s.shape[:-1], 4, 4)
    a0, a1, a2, a3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    x0, x1, x2, x3 = map(_xtime_np, (a0, a1, a2, a3))
    b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    return np.stack([b0, b1, b2, b3], axis=-1).reshape(s.shape)


def encrypt_blocks_np(blocks: np.ndarray, round_keys: np.ndarray) -> np.ndarray:
    """blocks: (B, 16) uint8; round_keys: (15, 16)."""
    s = blocks ^ round_keys[0]
    for r in range(1, N_ROUNDS):
        s = SBOX[s]
        s = s[..., SHIFT_PERM]
        s = _mix_columns_np(s)
        s = s ^ round_keys[r]
    s = SBOX[s]
    s = s[..., SHIFT_PERM]
    return s ^ round_keys[N_ROUNDS]


def oracle(data: np.ndarray, key: np.ndarray) -> np.ndarray:
    rk = expand_key(key)
    blocks = np.asarray(data, np.uint8).reshape(-1, 16)
    return encrypt_blocks_np(blocks, rk).reshape(-1)


# ---------------------------------------------------------------------------
# torch implementation, per level
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The S-box (uint8) and ShiftRows permutation (int64) on ``device``,
    copied there once."""
    return (torch.as_tensor(SBOX, device=device),
            torch.as_tensor(SHIFT_PERM, dtype=torch.int64, device=device))


def _xtime(x):
    # uint8 << 1 drops bit 7, as the reference's & 0xFF does
    return (x << 1) ^ (((x >> 7) & 1) * 0x1B)


def _mix_columns(s):
    c = s.reshape(*s.shape[:-1], 4, 4)
    a0, a1, a2, a3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    x0, x1, x2, x3 = map(_xtime, (a0, a1, a2, a3))
    b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def encrypt_blocks(blocks: torch.Tensor, round_keys: torch.Tensor
                   ) -> torch.Tensor:
    """Fully vectorised rounds over (..., 16) uint8 blocks; ``round_keys``
    is the (15, 16) uint8 schedule on the blocks' device."""
    sbox, perm = _tables(blocks.device)
    s = blocks ^ round_keys[0]
    for r in range(1, N_ROUNDS):
        s = sbox[s.long()]
        s = s[..., perm]
        s = _mix_columns(s)
        s = s ^ round_keys[r]
    s = sbox[s.long()]
    s = s[..., perm]
    return s ^ round_keys[N_ROUNDS]


def _encrypt_block_bytewise(blk: torch.Tensor, round_keys: torch.Tensor):
    """O0/O1 compute: one 16-byte block, byte loops explicit (a loop over
    the 16 lanes for SubBytes/AddRoundKey — the un-pipelined inner loop).
    Lanes are one-element slices, so no index is read back to the host."""
    sbox, perm = _tables(blk.device)

    def sub_ark(s, rk):
        acc = torch.zeros_like(s)
        for i in range(BLOCK):
            acc[i:i + 1] = sbox[s[i:i + 1].long()] ^ rk[i:i + 1]
        return acc

    s = blk ^ round_keys[0]
    for r in range(1, N_ROUNDS):
        s = sub_ark(s, torch.zeros_like(round_keys[r]))   # SubBytes
        s = s[perm]
        s = _mix_columns(s)
        s = s ^ round_keys[r]
    s = sbox[s.long()][perm]
    return s ^ round_keys[N_ROUNDS]


def _run_o0(data, rk):
    buf = data.clone()
    for i in range(data.shape[0] // BLOCK):
        blk = buf[i * BLOCK:(i + 1) * BLOCK]
        buf[i * BLOCK:(i + 1) * BLOCK] = _encrypt_block_bytewise(blk, rk)
    return buf


def _run_o1(data, rk):
    slabs = data.reshape(-1, BATCH_BYTES)
    out = torch.empty_like(slabs)
    for k in range(slabs.shape[0]):
        buf = slabs[k].clone()           # the slab staged
        for i in range(BATCH_BLOCKS):
            blk = buf[i * BLOCK:(i + 1) * BLOCK]
            buf[i * BLOCK:(i + 1) * BLOCK] = _encrypt_block_bytewise(blk, rk)
        out[k] = buf
    return out.reshape(-1)


def _run_o2(data, rk):
    slabs = data.reshape(-1, BATCH_BLOCKS, BLOCK)
    out = torch.empty_like(slabs)
    for k in range(slabs.shape[0]):
        for i in range(BATCH_BLOCKS):
            out[k, i] = encrypt_blocks(slabs[k, i], rk)
    return out.reshape(-1)


def _run_o3(data, rk):
    slabs = data.reshape(-1, PE_NUM, BATCH_BLOCKS // PE_NUM, BLOCK)
    out = torch.empty_like(slabs)
    for k in range(slabs.shape[0]):     # (PE, blocks/PE, 16) at once
        out[k] = encrypt_blocks(slabs[k], rk)
    return out.reshape(-1)


def _run_o4(data, rk, *, packed=False):
    """Fig. 4(c): 3-slot rotation.  Phase i loads slab i into slot i%3,
    computes slot (i-1)%3, stores slot (i-2)%3.  The slots and the output
    are written in place (the reference updates them functionally); the
    values each phase reads are the same."""
    slabs = data.reshape(-1, BATCH_BYTES)
    n = slabs.shape[0]

    if packed:                              # O5: wide-word staging buffers
        slabs = pack_u8_to_u32(slabs)

    def compute(slab):
        u8 = unpack_u32_to_u8(slab) if packed else slab
        enc = encrypt_blocks(u8.reshape(PE_NUM, -1, BLOCK), rk).reshape(-1)
        return pack_u8_to_u32(enc) if packed else enc

    bufs0 = {
        "slots": torch.zeros((3,) + slabs.shape[1:], dtype=slabs.dtype,
                             device=slabs.device),
        "out": torch.zeros_like(slabs),
    }

    def body(i, slot, bufs):
        bufs["slots"][slot] = slabs[min(i, n - 1)]     # load phase i
        computed = compute(bufs["slots"][(i - 1) % 3])
        if i >= 1:                                      # store phase i-1
            bufs["out"][i - 1] = computed
        return bufs

    out = rotate3(body, n + 1, bufs0)["out"]
    if packed:
        out = unpack_u32_to_u8(out)
    return out.reshape(-1)


def run(level: OptLevel, data, key, *, device=None) -> torch.Tensor:
    """Encrypt ``data`` (uint8, len % BATCH_BYTES == 0) at one opt level,
    on the CUDA device unless ``device="cpu"``; ``data`` and ``key`` are
    numpy arrays or tensors.  Returns the (n,) uint8 ciphertext."""
    dev = resolve_device(device)
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    rk = torch.as_tensor(expand_key(np.asarray(key)), device=dev)
    data = torch.as_tensor(data, dtype=torch.uint8, device=dev)
    level = OptLevel(level)
    if level == OptLevel.O0:
        return _run_o0(data, rk)
    if level == OptLevel.O1:
        return _run_o1(data, rk)
    if level == OptLevel.O2:
        return _run_o2(data, rk)
    if level == OptLevel.O3:
        return _run_o3(data, rk)
    if level == OptLevel.O4:
        return _run_o4(data, rk, packed=False)
    return _run_o4(data, rk, packed=True)


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    n = max(BATCH_BYTES, int(64e6 * scale) // BATCH_BYTES * BATCH_BYTES)
    return {
        "data": rng.integers(0, 256, n, dtype=np.uint8),
        "key": rng.integers(0, 256, 32, dtype=np.uint8),
    }
