"""The port's byte-typed MachSuite kernels (aes, kmp, nw) and their
packed-word helpers against the reference's: the same inputs from the
same generator, the host tables equal, the packed words equal bit for
bit, and every level O0..O5 exactly equal to the reference's ``run``
and to the numpy oracle (``tests/test_machsuite.py``'s scales and
properties), on the CPU."""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.machsuite import aes as jaes
from repro.machsuite import common as jcommon
from repro.machsuite import kmp as jkmp
from repro.machsuite import nw as jnw
from repro_torch.autotune import KernelModelBackend, autotune
from repro_torch.core import costmodel
from repro_torch.core.optlevel import OptLevel
from repro_torch.machsuite import KERNELS, aes, common, kmp, nw

MODS = {"aes": (aes, jaes), "kmp": (kmp, jkmp), "nw": (nw, jnw)}
# the reference tests' scales (tests/test_machsuite.py), kept on each module
SCALES = {name: mod.TEST_SCALE for name, (mod, _) in MODS.items()}
WIDER = {"aes": 4096 / 64e6, "kmp": 8192 / 128e6, "nw": 2 / 4096}
# the reference's autotune test scales (tests/test_autotune.py)
SMALL_SCALES = {"aes": 512 / 64e6, "kmp": 1024 / 128e6, "nw": 0.5 / 4096}
# ... and those of its other kernels there (tests/test_torch_machsuite_rest.py
# holds their levels to the reference)
AUTOTUNE_SCALES = {**SMALL_SCALES, "sort": 64 / 262144 / 16,
                   "viterbi": 0.5 / 62500}
OUT_DTYPES = {"aes": torch.uint8, "kmp": torch.int32, "nw": torch.int32}


def _held(name, lvl, inp, msg=""):
    """Run ``name`` at ``lvl`` on the CPU; assert it equals the oracle and
    the reference's ``run`` exactly, dtype and shape included."""
    mod, jmod = MODS[name]
    out = mod.run(OptLevel(lvl), **inp, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == OUT_DTYPES[name], out.dtype
    out = out.numpy()
    ref = np.asarray(mod.oracle(**inp))
    theirs = np.asarray(jmod.run(lvl, **inp))
    assert out.shape == ref.shape == theirs.shape, (out.shape, ref.shape)
    np.testing.assert_array_equal(out, ref, err_msg=f"{msg} vs oracle")
    np.testing.assert_array_equal(out, theirs, err_msg=f"{msg} vs reference")
    return out


# ---------------------------------------------------------------------------
# Inputs and host tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", sorted(MODS))
def test_make_inputs_is_bit_identical_to_the_reference(name, wide, seed):
    mod, jmod = MODS[name]
    scale = (WIDER if wide else SCALES)[name]
    mine = mod.make_inputs(np.random.default_rng(seed), scale)
    theirs = jmod.make_inputs(np.random.default_rng(seed), scale)
    assert mine.keys() == theirs.keys()
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_aes_tables_equal_the_reference():
    np.testing.assert_array_equal(aes.SBOX, jaes.SBOX)
    assert aes.SBOX.dtype == jaes.SBOX.dtype == np.uint8
    assert sorted(aes.SBOX.tolist()) == list(range(256))   # a permutation
    np.testing.assert_array_equal(aes.SHIFT_PERM, jaes.SHIFT_PERM)
    assert aes.SHIFT_PERM.dtype == jaes.SHIFT_PERM.dtype
    assert (aes.N_ROUNDS, aes.BLOCK, aes.BATCH_BLOCKS, aes.PE_NUM) == (
        jaes.N_ROUNDS, jaes.BLOCK, jaes.BATCH_BLOCKS, jaes.PE_NUM)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_key_equals_the_reference(seed):
    key = np.random.default_rng(seed).integers(0, 256, 32, dtype=np.uint8)
    mine, theirs = aes.expand_key(key), jaes.expand_key(key)
    assert mine.shape == (15, 16) and mine.dtype == theirs.dtype
    np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("pattern", [
    [0, 1, 0, 1, 0, 0, 1], [2, 2, 2, 2], [1, 2, 3, 1, 2, 3, 1, 2],
    list(range(16)), "seeded"])
def test_kmp_tables_equal_the_reference(pattern):
    if pattern == "seeded":
        pattern = kmp.make_inputs(np.random.default_rng(0),
                                  SCALES["kmp"])["pattern"]
    p = np.asarray(pattern, np.uint8)
    for mine, theirs in ((kmp.failure_fn(p), jkmp.failure_fn(p)),
                         (kmp.dfa_table(p), jkmp.dfa_table(p))):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    assert kmp.dfa_table(p).shape == (len(p) + 1, kmp.ALPHABET)


# ---------------------------------------------------------------------------
# Packed words
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8,), (3, 16), (2, 5, 12)])
def test_pack_matches_the_reference_bit_for_bit(shape):
    r = np.random.default_rng(sum(shape))
    x = r.integers(0, 256, shape, dtype=np.uint8)
    x[..., ::4] |= 0x80                 # byte 0 of every word >= 0x80
    x[..., 3::4] |= 0x80                # byte 3 too: the word reads < 0
    x.reshape(-1)[1] = 0xFF
    words = common.pack_u8_to_u32(torch.as_tensor(x))
    assert words.dtype == torch.int32
    theirs = np.asarray(jcommon.pack_u8_to_u32(x))
    assert theirs.dtype == np.uint32
    assert words.shape == theirs.shape == shape[:-1] + (shape[-1] // 4,)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), theirs)
    # round trip, and the reference's words unpack to the same bytes
    back = common.unpack_u32_to_u8(words)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), x)
    from_theirs = common.unpack_u32_to_u8(
        torch.as_tensor(theirs.view(np.int32)))
    np.testing.assert_array_equal(
        from_theirs.numpy(), np.asarray(jcommon.unpack_u32_to_u8(theirs)))


def test_pack_covers_every_byte_in_every_lane():
    x = np.stack([np.arange(256, dtype=np.uint8)] * 4, axis=-1)   # (256, 4)
    for lane in range(4):
        x[:, lane] = np.roll(x[:, lane], 37 * lane)
    words = common.pack_u8_to_u32(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(words.view(np.uint32)[:, 0],
                                  np.asarray(jcommon.pack_u8_to_u32(x))[:, 0])
    np.testing.assert_array_equal(
        common.unpack_u32_to_u8(torch.as_tensor(words)).numpy(), x)


# ---------------------------------------------------------------------------
# Every level against the reference and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("lvl", range(6))
@pytest.mark.parametrize("name", sorted(MODS))
def test_level_matches_reference_and_oracle(name, lvl, seed):
    mod, _ = MODS[name]
    inp = mod.make_inputs(np.random.default_rng(seed), SCALES[name])
    _held(name, lvl, inp, f"{name} O{lvl} seed {seed}")


@pytest.mark.parametrize("lvl", range(6))
def test_nw_at_a_length_that_pads_the_packed_words(lvl):
    """L = 10: O5 pads each sequence to 12 bytes (3 words) before packing."""
    r = np.random.default_rng(10)
    inp = {"seq_a": r.integers(0, 4, (16, 10), dtype=np.uint8),
           "seq_b": r.integers(0, 4, (16, 10), dtype=np.uint8)}
    _held("nw", lvl, inp, f"nw L=10 O{lvl}")


@pytest.mark.parametrize("lvl", [2, 3, 4, 5])
def test_nw_at_table_3s_length(lvl):
    """L = 128 (Table 3's), 32 pairs: two batches through the wavefront
    levels (O0/O1 issue L^2 single-cell steps a pair and stay at L = 8)."""
    r = np.random.default_rng(128)
    inp = {"seq_a": r.integers(0, 4, (32, 128), dtype=np.uint8),
           "seq_b": r.integers(0, 4, (32, 128), dtype=np.uint8)}
    inp["seq_b"][3] = inp["seq_a"][3]           # one perfect alignment
    out = _held("nw", lvl, inp, f"nw L=128 O{lvl}")
    assert out[3] == 128 * nw.MATCH


@pytest.mark.parametrize("lvl", range(6))
def test_kmp_counts_matches_across_chunk_and_pe_edges(lvl):
    """A short pattern on a binary text, with occurrences planted across
    every chunk and PE boundary, so the count is far from 0 (the 16-char
    pattern of the reference's scale finds none)."""
    r = np.random.default_rng(7)
    text = r.integers(0, 2, 1024, dtype=np.uint8)
    pattern = np.array([1, 0, 1, 1, 0], np.uint8)
    for edge in range(128, 1024, 128):          # 8 chunks = 8 PE spans
        text[edge - 2:edge + 3] = pattern
    # the text ends in the pattern less its last char, a 0: the last PE's
    # zero halo would complete it, and that match must not count
    text[-4:] = pattern[:4]
    inp = {"text": text, "pattern": pattern}
    out = _held("kmp", lvl, inp, f"kmp O{lvl}")
    assert out > 20


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("lvl", range(6))
def test_kmp_planted_matches_at_the_reference_scale(lvl, seed):
    """The card's kmp check with matches to count: the reference-scale
    text with a 5-character pattern planted across every chunk and PE
    edge (``kmp.with_planted_matches``)."""
    inp = kmp.with_planted_matches(
        kmp.make_inputs(np.random.default_rng(seed), SCALES["kmp"]))
    assert int(kmp.oracle(**inp)) >= kmp.PE_NUM
    _held("kmp", lvl, inp, f"kmp planted O{lvl} seed {seed}")


def test_run_accepts_tensors_and_leaves_its_inputs_alone():
    inps = {name: MODS[name][0].make_inputs(np.random.default_rng(5),
                                            SMALL_SCALES[name])
            for name in MODS}
    for name, inp in inps.items():
        mod = MODS[name][0]
        want = np.asarray(mod.oracle(**inp))
        kept = {k: v.copy() for k, v in inp.items()}
        for lvl in range(6):
            out = mod.run(lvl, **inp, device="cpu")
            np.testing.assert_array_equal(out.numpy(), want)
            out_t = mod.run(lvl, **{k: torch.as_tensor(v)
                                    for k, v in inp.items()}, device="cpu")
            np.testing.assert_array_equal(out_t.numpy(), want)
            for k in inp:            # O0/O1 write a staged copy in place
                np.testing.assert_array_equal(inp[k], kept[k], err_msg=k)


# ---------------------------------------------------------------------------
# AES properties
# ---------------------------------------------------------------------------

FIPS_KEY = np.arange(32, dtype=np.uint8)
FIPS_PT = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                        np.uint8)
FIPS_CT = "8ea2b7ca516745bfeafc49904b496089"


def test_aes_fips197_c3_through_the_torch_rounds():
    rk = torch.as_tensor(aes.expand_key(FIPS_KEY))
    pt = torch.as_tensor(FIPS_PT.copy())
    ct = aes.encrypt_blocks(pt[None, :], rk)[0]
    assert ct.numpy().tobytes().hex() == FIPS_CT
    assert aes._encrypt_block_bytewise(
        pt, rk).numpy().tobytes().hex() == FIPS_CT
    assert aes.encrypt_blocks_np(
        FIPS_PT[None, :], aes.expand_key(FIPS_KEY))[0].tobytes().hex() == (
            FIPS_CT)


@pytest.mark.parametrize("lvl", range(6))
def test_aes_fips197_c3_at_every_level(lvl):
    data = np.tile(FIPS_PT, aes.BATCH_BLOCKS)
    out = aes.run(lvl, data, FIPS_KEY, device="cpu").numpy().reshape(-1, 16)
    assert {bytes(row).hex() for row in out} == {FIPS_CT}


# ---------------------------------------------------------------------------
# KMP and NW properties (tests/test_machsuite.py's, through the port)
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 6))
def test_kmp_counts_overlapping(seed, m):
    r = np.random.default_rng(seed)
    text = r.integers(0, 2, 256, dtype=np.uint8)   # binary => many matches
    pattern = r.integers(0, 2, m, dtype=np.uint8)
    expect = sum(
        1 for i in range(len(text) - m + 1)
        if (text[i:i + m] == pattern).all())
    assert int(kmp.oracle(text, pattern)) == expect
    for lvl in range(6):
        assert int(kmp.run(lvl, text, pattern, device="cpu")) == expect, lvl


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(4, 16))
def test_nw_properties(seed, L):
    r = np.random.default_rng(seed)
    a = r.integers(0, 4, (1, L), dtype=np.uint8)
    b = r.integers(0, 4, (1, L), dtype=np.uint8)
    run = lambda x, y: int(nw.run(OptLevel.O0, x, y, device="cpu")[0])
    s_ab = run(a, b)
    assert s_ab == int(nw.oracle(a, b)[0])
    assert s_ab == run(b, a)                  # symmetric scoring scheme
    assert s_ab <= L * nw.MATCH               # bounded by all-match
    assert run(a, a) == L * nw.MATCH          # self-alignment
    # the batched, packed rung on the pair repeated over a batch
    tile = lambda x: np.repeat(x, nw.BATCH, axis=0)
    assert set(nw.run(OptLevel.O5, tile(a), tile(b),
                      device="cpu").tolist()) == {s_ab}


# ---------------------------------------------------------------------------
# Registry and the tuner's level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODS))
def test_registered_with_the_references_profile(name):
    mod = MODS[name][0]
    assert KERNELS[name] is mod
    from test_machsuite import SCALES as REFERENCE_TEST_SCALES
    assert mod.TEST_SCALE == REFERENCE_TEST_SCALES[name]
    assert mod.PROFILE is costmodel.MACHSUITE_PROFILES[name]
    assert mod.PROFILE.name == name


@pytest.mark.parametrize("name", sorted(AUTOTUNE_SCALES))
def test_autotuned_level_is_output_equivalent(name, rng):
    """The port's counterpart of ``tests/test_autotune.py``'s test: the
    level the tuner picks computes the oracle's function."""
    res = autotune(KernelModelBackend(costmodel.MACHSUITE_PROFILES[name]))
    level = OptLevel(res.final.measurement.meta["level"])
    mod = KERNELS[name]
    inp = mod.make_inputs(rng, AUTOTUNE_SCALES[name])
    out = mod.run(level, **inp, device="cpu").numpy()
    ref = np.asarray(mod.oracle(**inp))
    if out.dtype.kind == "f":
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=1e-5)
    else:
        np.testing.assert_array_equal(out, ref)
