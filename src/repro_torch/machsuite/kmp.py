"""KMP string matching — paper Table 3: 128 MB string, 16 B substring
(port of ``repro/machsuite/kmp.py``).

Output: the number of occurrences (the paper notes KMP's output is "merely
an integer", which is why double buffering gains nothing for it), a 0-d
int32 tensor.

  O0  character scan with the classic failure-function backtrack (the
      while-loop inside the scan body = the un-pipelined inner loop)
  O1  text staged in chunks; same backtracking automaton per chunk
  O2  + the match loop compiled to a DFA: one table lookup per character,
      II=1 (the paper's "pipeline pragma" step — KMP gains 7.0x, Table 4)
  O3  + PE duplication: text split across PE chunks with (m-1)-overlap,
      each PE counts matches *starting* in its span (a batch dimension)
  O4  + 3-slot rotation over chunks (paper: ~no gain for KMP — Fig. 12)
  O5  + chunk staging in packed 32-bit words (char->int reorg; KMP is a
      top gainer for scratchpad reorg in the paper: byte-typed buffers)

Every rung issues a few tensor operations per character.  O0/O1's
backtracking loop has a data-dependent trip count: its condition is
evaluated on the host, one device-to-host read per trip (on the card a
synchronisation each time) — the port's analogue of the un-pipelined
loop.  A fixed m-step masked loop would be another rung.  Table lookups
index with ``int64``: a ``uint8`` index tensor is taken as a boolean mask.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.costmodel import MACHSUITE_PROFILES
from repro_torch.device import resolve_device
from repro_torch.machsuite.common import (OptLevel, pack_u8_to_u32, rotate3,
                                          unpack_u32_to_u8)

PROFILE = MACHSUITE_PROFILES["kmp"]

PE_NUM = 8
N_CHUNKS = 8        # O1/O2's staging chunks (the reference's default)
ALPHABET = 256
# the reference tests' scale (4,096 characters): the port's tests and
# the card's check in chip_smoke.py run every level at it
TEST_SCALE = 4096 / 128e6


def failure_fn(pattern: np.ndarray) -> np.ndarray:
    """Classic KMP failure (longest proper prefix-suffix) table."""
    p = np.asarray(pattern, np.uint8)
    m = len(p)
    fail = np.zeros(m, np.int32)
    k = 0
    for i in range(1, m):
        while k > 0 and p[i] != p[k]:
            k = fail[k - 1]
        if p[i] == p[k]:
            k += 1
        fail[i] = k
    return fail


def dfa_table(pattern: np.ndarray) -> np.ndarray:
    """(m+1, 256) next-state table: state = chars of pattern matched."""
    p = np.asarray(pattern, np.uint8)
    m = len(p)
    fail = failure_fn(p)
    dfa = np.zeros((m + 1, ALPHABET), np.int32)
    for s in range(m + 1):
        for c in range(ALPHABET):
            if s < m and c == p[s]:
                dfa[s, c] = s + 1
            elif s == 0:
                dfa[s, c] = 0
            else:
                # follow failure links from the longest border
                k = fail[s - 1] if s <= m else 0
                dfa[s, c] = dfa[k, c]
    # state m (full match) continues from its border, same as other rows
    return dfa


def oracle(text: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    t = np.asarray(text, np.uint8)
    p = np.asarray(pattern, np.uint8)
    m = len(p)
    if len(t) < m:
        return np.int32(0)
    windows = np.lib.stride_tricks.sliding_window_view(t, m)
    return np.int32((windows == p).all(axis=1).sum())


# ---------------------------------------------------------------------------
# levels
# ---------------------------------------------------------------------------

def _scan_backtrack(text, pat, fail, j, count):
    """O0/O1 inner automaton: per-char backtracking while-loop.  ``j`` and
    ``count`` are one-element tensors (int64, int32) carried in and out."""
    m = pat.shape[0]
    for k in range(text.shape[0]):
        c = text[k:k + 1]
        # host-evaluated condition: one device-to-host read per trip
        while bool(((j > 0) & (pat[j] != c)).item()):
            j = fail[j - 1]
        j = torch.where(pat[j] == c, j + 1, j)
        matched = j == m
        count = count + matched.to(torch.int32)
        j = torch.where(matched, fail[m - 1], j)
    return count, j


def _start(device):
    return (torch.zeros(1, dtype=torch.int64, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def _run_o0(text, pat, fail):
    j, count = _start(text.device)
    count, _ = _scan_backtrack(text, pat, fail, j, count)
    return count.reshape(())


def _chunks(text):
    return text.reshape(N_CHUNKS, -1)


def _run_o1(text, pat, fail):
    chunks = _chunks(text)
    j, count = _start(text.device)
    for k in range(chunks.shape[0]):
        chunk = chunks[k].clone()          # the chunk staged
        count, j = _scan_backtrack(chunk, pat, fail, j, count)
    return count.reshape(())


def _dfa_scan(chunk, dfa, m, s):
    """II=1 automaton over the last axis of ``chunk`` (uint8 (..., W)):
    one lookup per char from state ``s`` (int64 (..., 1)).  Returns the
    final state and the per-position match flags (int32 (..., W))."""
    c = chunk.long()
    hits = torch.empty(chunk.shape, dtype=torch.int32, device=chunk.device)
    for k in range(chunk.shape[-1]):
        s = dfa[s, c[..., k:k + 1]]
        hits[..., k:k + 1] = s == m
    return s, hits


def _run_o2(text, dfa, m):
    chunks = _chunks(text)
    s, count = _start(text.device)
    for k in range(chunks.shape[0]):
        s, hits = _dfa_scan(chunks[k], dfa, m, s)
        count = count + hits.sum(dtype=torch.int32)
    return count.reshape(())


def _pe_split(text, m):
    """Split text into PE_NUM spans + (m-1)-char halo from the next span."""
    T = text.shape[0]
    assert T % PE_NUM == 0, (T, PE_NUM)
    span = T // PE_NUM
    padded = torch.cat([text, text.new_zeros(m - 1)])
    idx = (torch.arange(span + m - 1, device=text.device)[None, :]
           + (torch.arange(PE_NUM, device=text.device) * span)[:, None])
    return padded[idx], span


def _in_span(pos, pe, span, m, T):
    """Count a match whose *start* is inside this PE's span AND whose end
    is inside the real text (halo padding must not count): a match ending
    at local e starts at e-m+1."""
    return (pos - (m - 1) < span) & (pe * span + pos < T)


def _run_o3(text, dfa, m):
    ext, span = _pe_split(text, m)                  # (PE, span+m-1)
    T = text.shape[0]
    s0 = torch.zeros((PE_NUM, 1), dtype=torch.int64, device=text.device)
    _, hits = _dfa_scan(ext, dfa, m, s0)            # every PE at once
    pos = torch.arange(ext.shape[1], device=text.device)
    pe = torch.arange(PE_NUM, device=text.device)[:, None]
    return (hits * _in_span(pos, pe, span, m, T)).sum(dtype=torch.int32)


def _run_o4(text, dfa, m, *, packed=False):
    """3-slot rotation over the PE chunks; the slots are written in place
    (the reference updates them functionally)."""
    ext, span = _pe_split(text, m)   # (PE, span+m-1)
    n = ext.shape[0]
    width = ext.shape[1]
    pad = (-width) % 4
    ext_p = torch.nn.functional.pad(ext, (0, pad))
    staged = pack_u8_to_u32(ext_p) if packed else ext_p

    T = text.shape[0]
    pos = torch.arange(width, device=text.device)
    s0 = torch.zeros(1, dtype=torch.int64, device=text.device)

    def compute(chunk, pe):
        u8 = unpack_u32_to_u8(chunk) if packed else chunk
        u8 = u8[:width]
        _, hits = _dfa_scan(u8, dfa, m, s0)
        return (hits * _in_span(pos, pe, span, m, T)).sum(dtype=torch.int32)

    bufs0 = {
        "slots": torch.zeros((3,) + staged.shape[1:], dtype=staged.dtype,
                             device=staged.device),
        "count": torch.zeros((), dtype=torch.int32, device=text.device),
    }

    def body(i, slot, bufs):
        bufs["slots"][slot] = staged[min(i, n - 1)]
        add = compute(bufs["slots"][(i - 1) % 3], max(i - 1, 0))
        if i >= 1:
            bufs["count"] = bufs["count"] + add
        return bufs

    return rotate3(body, n + 1, bufs0)["count"]


def run(level: OptLevel, text, pattern, *, device=None) -> torch.Tensor:
    """The number of (overlapping) occurrences of ``pattern`` in ``text``
    at one opt level, a 0-d int32 tensor on the CUDA device unless
    ``device="cpu"``; ``text`` and ``pattern`` are uint8 numpy arrays or
    tensors."""
    dev = resolve_device(device)
    if isinstance(pattern, torch.Tensor):
        pattern = pattern.cpu().numpy()
    pattern = np.asarray(pattern, np.uint8)
    m = len(pattern)
    text = torch.as_tensor(text, dtype=torch.uint8, device=dev)
    level = OptLevel(level)
    if level <= OptLevel.O1:
        pat = torch.as_tensor(pattern, device=dev)
        fail = torch.as_tensor(failure_fn(pattern), dtype=torch.int64,
                               device=dev)
        if level == OptLevel.O0:
            return _run_o0(text, pat, fail)
        return _run_o1(text, pat, fail)
    dfa = torch.as_tensor(dfa_table(pattern), dtype=torch.int64, device=dev)
    if level == OptLevel.O2:
        return _run_o2(text, dfa, m)
    if level == OptLevel.O3:
        return _run_o3(text, dfa, m)
    if level == OptLevel.O4:
        return _run_o4(text, dfa, m, packed=False)
    return _run_o4(text, dfa, m, packed=True)


def with_planted_matches(inp: dict) -> dict:
    """``inp``'s text with a short pattern, its own first 5 characters,
    planted across every chunk and PE edge.  At the reference tests'
    scale the 16-character pattern occurs nowhere, so a rung that always
    counted 0 would pass there; here the count is at least ``PE_NUM``."""
    m = 5
    text = np.array(inp["text"], np.uint8)
    pattern = text[:m].copy()
    span = text.size // PE_NUM          # = the O1/O2 chunk (N_CHUNKS)
    for edge in range(span, text.size, span):
        text[edge - m // 2:edge - m // 2 + m] = pattern
    return {"text": text, "pattern": pattern}


def make_inputs(rng: np.random.Generator, scale: float = 1.0) -> dict:
    n = max(PE_NUM * 64, int(128e6 * scale) // (PE_NUM * 8) * (PE_NUM * 8))
    # small alphabet => plenty of matches to count
    text = rng.integers(0, 4, n, dtype=np.uint8)
    pattern = rng.integers(0, 4, 16, dtype=np.uint8)
    return {"text": text, "pattern": pattern}
