"""The port's last four MachSuite kernels (bfs, sort, spmv, viterbi)
against the reference's: the same inputs from the same generator, and
every level O0..O5 equal to the reference's ``run`` and to the numpy
oracle — ints and viterbi exactly, spmv at the reference's tolerance —
with ``tests/test_machsuite.py``'s scales and properties, on the CPU."""

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.machsuite import bfs as jbfs
from repro.machsuite import sort as jsort
from repro.machsuite import spmv as jspmv
from repro.machsuite import viterbi as jviterbi
from repro_torch.core import costmodel
from repro_torch.core.optlevel import OptLevel
from repro_torch.machsuite import KERNELS, bfs, sort, spmv, viterbi

MODS = {"bfs": (bfs, jbfs), "sort": (sort, jsort), "spmv": (spmv, jspmv),
        "viterbi": (viterbi, jviterbi)}
# the reference tests' scales (tests/test_machsuite.py), kept on each module
SCALES = {name: mod.TEST_SCALE for name, (mod, _) in MODS.items()}
# a second scale each: bfs 32 nodes / 512 edges (O1 runs 2 tiles), sort 2
# chunks of 64, spmv 128 rows of 16, viterbi 32 chains
WIDER = {"bfs": 32 / 4096, "sort": 1 / 4096, "spmv": 2 / 64,
         "viterbi": 2 / 62500}
OUT_DTYPES = {"bfs": torch.int32, "sort": torch.int32,
              "spmv": torch.float32, "viterbi": torch.float32}


def _same(name, out, want, msg):
    if name == "spmv":      # O2+ sum a row's lanes in another order
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=1e-5,
                                   err_msg=msg)
    else:
        np.testing.assert_array_equal(out, want, err_msg=msg)


def _held(name, lvl, inp, msg=""):
    """Run ``name`` at ``lvl`` on the CPU; assert it equals the oracle and
    the reference's ``run`` (spmv within the reference's tolerance),
    dtype and shape included."""
    mod, jmod = MODS[name]
    out = mod.run(OptLevel(lvl), **inp, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == OUT_DTYPES[name], out.dtype
    out = out.numpy()
    ref = np.asarray(mod.oracle(**inp))
    theirs = np.asarray(jmod.run(lvl, **inp))
    assert out.shape == ref.shape == theirs.shape, (out.shape, ref.shape)
    _same(name, out, ref, f"{msg} vs oracle")
    _same(name, out, theirs, f"{msg} vs reference")
    return out


# ---------------------------------------------------------------------------
# Inputs
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
        assert np.asarray(mine[k]).dtype == np.asarray(theirs[k]).dtype
        np.testing.assert_array_equal(mine[k], theirs[k])


def test_viterbi_table_3_cut_draws_table_3s_hmm():
    """The card's cut: 64 chains of Table 3's HMM (S = M = 64, T = 128),
    drawn as the reference draws scale 1, not sliced from 1M chains."""
    inp = viterbi.make_inputs(np.random.default_rng(0), 1.0, n_chains=64)
    assert inp["obs"].shape == (64, 128) and inp["obs"].dtype == np.int32
    assert 0 <= inp["obs"].min() and inp["obs"].max() < 64
    assert inp["init"].shape == (64,)
    assert inp["trans"].shape == inp["emit"].shape == (64, 64)
    for probs in (inp["init"], inp["trans"], inp["emit"]):
        np.testing.assert_allclose(np.exp(-probs.astype(np.float64)).sum(-1),
                                   1.0, rtol=1e-5)
    # below scale 1 the override keeps the scale's T, S and M
    small = viterbi.make_inputs(np.random.default_rng(0), SCALES["viterbi"],
                                n_chains=24)
    assert small["obs"].shape == (24, 4) and small["emit"].shape == (8, 16)


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
def test_bfs_where_o1_runs_two_tiles(lvl, monkeypatch):
    """32 nodes, 512 edges: O1 relaxes each level in 2 staged tiles of
    256 (at the reference tests' 256 edges it is one tile and takes O2's
    relaxation); the other levels never tile."""
    seen = []
    relax_tiles = bfs._relax_tiles

    def counted(dist, level, edge_src, edge_dst, n_tiles):
        seen.append(n_tiles)
        return relax_tiles(dist, level, edge_src, edge_dst, n_tiles)

    monkeypatch.setattr(bfs, "_relax_tiles", counted)
    inp = bfs.make_inputs(np.random.default_rng(0), WIDER["bfs"])
    assert inp["neighbors"].size == 2 * bfs.EDGE_TILE
    out = _held("bfs", lvl, inp, f"bfs 32/4096 O{lvl}")
    assert out.max() >= 2
    if lvl == 1:
        # one tiled relaxation a level, the last finding nothing new
        assert seen and set(seen) == {2}
        assert len(seen) == out.max() + 1
    else:
        assert seen == []


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("lvl", range(6))
def test_bfs_with_unreachable_nodes(lvl, seed):
    """The tests' graphs reach every node; ``with_unreachable`` appends
    isolated nodes, so at least a quarter of the distances are -1."""
    base = bfs.make_inputs(np.random.default_rng(seed), SCALES["bfs"])
    assert (bfs.oracle(**base) >= 0).all()
    inp = bfs.with_unreachable(base)
    n = inp["offsets"].size - 1
    assert n > base["offsets"].size - 1
    want = bfs.oracle(**inp)
    assert (want == -1).sum() >= n / 4
    out = _held("bfs", lvl, inp, f"bfs unreachable O{lvl} seed {seed}")
    np.testing.assert_array_equal(out[:base["offsets"].size - 1],
                                  bfs.oracle(**base))


def test_sort_network_sorts_every_zero_one_input():
    """The 0-1 principle: a comparator network that sorts every 0/1
    input of length 16 sorts every input of length 16."""
    n = 16
    bits = (torch.arange(2 ** n)[:, None] >> torch.arange(n)) & 1
    stages = sort.network(n, "cpu")
    assert len(stages) == 4 * 5 // 2                # log2(n)(log2(n)+1)/2
    out = sort._bitonic_sort(bits.to(torch.int32), stages)
    assert (out[:, 1:] >= out[:, :-1]).all()
    assert torch.equal(out.sum(-1), bits.sum(-1).to(torch.int32))


def test_sort_keeps_int32_extremes():
    """Keys at both ends of int32 stay exact through every level."""
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    data = np.array([hi, lo, 0, -1, 1, hi, lo, hi - 1, lo + 1, 7, -7, 3,
                     hi, 0, lo, 2] * 2, np.int32)
    for lvl in range(6):
        out = sort.run(lvl, data, 16, device="cpu").numpy()
        np.testing.assert_array_equal(out, sort.oracle(data, 16), f"O{lvl}")


def test_run_accepts_tensors_and_leaves_its_inputs_alone():
    for name, (mod, _) in MODS.items():
        inp = mod.make_inputs(np.random.default_rng(5), SCALES[name])
        want = np.asarray(mod.oracle(**inp))
        kept = {k: np.array(v, copy=True) for k, v in inp.items()}
        tensors = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                   for k, v in inp.items()}
        kept_t = {k: v.clone() for k, v in tensors.items()
                  if isinstance(v, torch.Tensor)}
        for lvl in range(6):
            for args in (inp, tensors):
                out = mod.run(lvl, **args, device="cpu").numpy()
                _same(name, out, want, f"{name} O{lvl}")
            for k in inp:        # sort O0/O1 write a copy in place
                np.testing.assert_array_equal(inp[k], kept[k], err_msg=k)
            for k, v in kept_t.items():
                assert torch.equal(tensors[k], v), (name, k)


# ---------------------------------------------------------------------------
# tests/test_machsuite.py's properties, through the port
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_sort_is_sorted_permutation(seed):
    r = np.random.default_rng(seed)
    chunk = 32
    data = r.integers(-1000, 1000, 4 * chunk, dtype=np.int32)
    out = sort.run(OptLevel.O3, data, chunk, device="cpu").numpy()
    out = out.reshape(-1, chunk)
    src = data.reshape(-1, chunk)
    for c in range(4):
        assert (np.diff(out[c]) >= 0).all()
        assert np.array_equal(np.sort(src[c]), out[c])


@pytest.mark.parametrize("lvl", range(6))
def test_bfs_triangle_inequality(lvl, rng):
    inp = bfs.make_inputs(rng, 32 / 4096)
    dist = bfs.run(lvl, **inp, device="cpu").numpy()
    off, nbr = inp["offsets"], inp["neighbors"]
    n = len(off) - 1
    assert dist[inp["source"]] == 0
    for u in range(n):
        if dist[u] < 0:
            continue
        for v in nbr[off[u]:off[u + 1]]:
            assert dist[v] >= 0 and dist[v] <= dist[u] + 1


def test_spmv_linearity(rng):
    inp = spmv.make_inputs(rng, 1 / 64)
    y1 = spmv.run(OptLevel.O3, **inp, device="cpu").numpy()
    y2 = spmv.run(OptLevel.O3, inp["vals"] * 2.0, inp["cols"], inp["x"],
                  device="cpu").numpy()
    np.testing.assert_allclose(y2, 2.0 * y1, rtol=1e-5)


def test_viterbi_beats_random_paths(rng):
    inp = viterbi.make_inputs(rng, 1 / 62500)
    best = viterbi.run(OptLevel.O2, **inp, device="cpu").numpy()
    obs, init, trans, emit = (inp["obs"], inp["init"], inp["trans"],
                              inp["emit"])
    S = init.shape[0]
    c = 0
    for _ in range(50):   # random path cost >= viterbi cost
        path = rng.integers(0, S, obs.shape[1])
        cost = init[path[0]] + emit[path[0], obs[c, 0]]
        for t in range(1, obs.shape[1]):
            cost += trans[path[t - 1], path[t]] + emit[path[t], obs[c, t]]
        assert cost >= best[c] - 1e-3


# ---------------------------------------------------------------------------
# Registry and structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODS))
def test_registered_with_the_references_profile(name):
    mod = MODS[name][0]
    assert KERNELS[name] is mod
    from test_machsuite import SCALES as REFERENCE_TEST_SCALES
    assert mod.TEST_SCALE == REFERENCE_TEST_SCALES[name]
    assert mod.PROFILE is costmodel.MACHSUITE_PROFILES[name]
    assert mod.PROFILE.name == name


@pytest.mark.parametrize("name", sorted(MODS))
def test_no_rung_calls_a_library_sort_or_sparse_product(name):
    """The rungs keep the reference's loops, networks and scatters: no
    call to a sort, a selection or a sparse product outside the numpy
    oracle and the input draws."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(MODS[name][0]))
    banned = {"sort", "argsort", "msort", "topk", "kthvalue", "sparse",
              "sparse_coo_tensor", "sparse_csr_tensor", "to_sparse"}
    for fn in ast.walk(tree):
        if (not isinstance(fn, ast.FunctionDef)
                or fn.name in ("oracle", "make_inputs")):
            continue
        for node in ast.walk(fn):
            attr = getattr(node, "attr", None) or getattr(node, "id", None)
            assert attr not in banned, (name, fn.name, attr)
