"""The port's paper layer against the reference's: the analytic cost model
(``core.costmodel``), the guideline, the closed-loop autotuner over
``KernelModelBackend`` (greedy and frontier) and its CLI give the
reference's numbers and records exactly — they are framework-free copies
— and the card's roofline arithmetic is the reference's formula."""

import dataclasses
import json

import numpy as np
import pytest

from repro.autotune import KernelModelBackend as JKernelModelBackend
from repro.autotune import autotune as jautotune
from repro.autotune import roofline_terms as jroofline_terms
from repro.core import costmodel as jcostmodel
from repro.core import guideline as jguideline
from repro.core.hw import TPU_V5E
from repro.core.optlevel import OptLevel as JOptLevel
from repro_torch.autotune import (KernelModelBackend, autotune,
                                  read_trajectory, render_rounds,
                                  render_summary, roofline_terms,
                                  trajectory_path, write_trajectory)
from repro_torch.autotune.__main__ import main
from repro_torch.core import costmodel, guideline
from repro_torch.core.hw import FPGA_2012, H100_SXM, GpuSpec
from repro_torch.core.optlevel import OptLevel, Step
from repro_torch.machsuite import KERNELS

NAMES = sorted(costmodel.MACHSUITE_PROFILES)


def tune(name, **kw):
    return autotune(KernelModelBackend(costmodel.MACHSUITE_PROFILES[name]),
                    **kw)


def test_profiles_and_platform_are_the_references():
    assert NAMES == sorted(jcostmodel.MACHSUITE_PROFILES) and len(NAMES) == 8
    for name in NAMES:
        assert (dataclasses.asdict(costmodel.MACHSUITE_PROFILES[name])
                == dataclasses.asdict(jcostmodel.MACHSUITE_PROFILES[name]))
    from repro.core.hw import FPGA_2012 as JFPGA
    assert dataclasses.asdict(FPGA_2012) == dataclasses.asdict(JFPGA)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("frontier", [False, True])
def test_autotune_records_equal_the_reference(name, frontier):
    mine = tune(name, frontier=frontier)
    theirs = jautotune(JKernelModelBackend(
        jcostmodel.MACHSUITE_PROFILES[name]), frontier=frontier)
    assert mine.to_records() == theirs.to_records()
    assert mine.steps_taken == theirs.steps_taken
    assert mine.rejected == theirs.rejected


@pytest.mark.parametrize("name", NAMES)
def test_refinement_curve_equals_the_reference(name):
    mine = costmodel.refinement_curve(costmodel.MACHSUITE_PROFILES[name])
    theirs = jcostmodel.refinement_curve(jcostmodel.MACHSUITE_PROFILES[name])
    assert mine == theirs and sorted(mine) == list(range(6))


def test_paper_validation_table_equals_the_reference():
    assert (costmodel.paper_validation_table()
            == jcostmodel.paper_validation_table())


@pytest.mark.parametrize("name", ["gemm", "aes", "sort"])
@pytest.mark.parametrize("lvl", range(6))
def test_resource_fit_equals_the_reference(name, lvl):
    kw = dict(cache_bytes=256 * 1024, pe=128)
    assert (costmodel.fit_resources(costmodel.MACHSUITE_PROFILES[name],
                                    OptLevel(lvl), **kw)
            == jcostmodel.fit_resources(jcostmodel.MACHSUITE_PROFILES[name],
                                        JOptLevel(lvl), **kw))


@pytest.mark.parametrize("terms", [
    dict(compute_s=2.0, memory_s=1.0),
    dict(compute_s=1.0, memory_s=2.0),
    dict(compute_s=1.0, memory_s=1.0, collective_s=3.0),
    dict(compute_s=1.0, memory_s=1.0, offload_s=2.0, baseline_s=1.0),
])
@pytest.mark.parametrize("lvl", range(6))
def test_guideline_recommends_the_references_step(terms, lvl):
    mine = guideline.recommend(level=OptLevel(lvl), **terms)
    theirs = jguideline.recommend(level=JOptLevel(lvl), **terms)
    assert (mine.step and mine.step.value) == (theirs.step
                                               and theirs.step.value)
    assert mine.stop == theirs.stop
    assert guideline.COMM_BOUND_THRESHOLD == jguideline.COMM_BOUND_THRESHOLD


def test_roofline_terms_at_a_tpu_valued_spec_equal_the_reference():
    tpu = GpuSpec(name="tpu_v5e", sms=1, smem_per_block=0,
                  hbm_bytes=TPU_V5E.hbm_bytes, hbm_bw=TPU_V5E.hbm_bw,
                  peak_bf16_flops=TPU_V5E.peak_bf16_flops, peak_f32_flops=0.0,
                  link_bw=TPU_V5E.ici_link_bw)
    for args, kw in [((197e12, 819e9 * 2, 50e9 / 2),
                      dict(chips=4, model_flops=197e12 * 2)),
                     ((1e12, 3e9, 0.0), dict(fused_bytes_per_device=1e9)),
                     ((0.0, 0.0, 0.0), {})]:
        assert roofline_terms(*args, spec=tpu, **kw) == jroofline_terms(
            *args, spec=TPU_V5E, **kw)


def test_roofline_terms_default_to_the_card():
    rec = roofline_terms(989e12, 3.35e12 * 2, 450e9 / 2)
    assert rec["compute_s"] == pytest.approx(1.0)
    assert rec["memory_s"] == pytest.approx(2.0)
    assert rec["collective_s"] == pytest.approx(0.5)
    assert rec["dominant"] == "memory"
    assert H100_SXM.sms == 132 and H100_SXM.peak_f32_flops == 67e12


def test_trajectory_roundtrip_and_render(tmp_path):
    res = tune("gemm")
    path = write_trajectory(res, out_dir=str(tmp_path))
    assert path == trajectory_path("gemm", str(tmp_path))
    recs = read_trajectory(path)
    assert recs == json.loads(json.dumps(res.to_records()))
    assert [r["label"] for r in recs] == [f"O{i}" for i in range(6)]
    assert render_rounds(recs).count("\n") == len(recs) + 1
    summary = render_summary([res, tune("bfs")])
    assert "REJECT (comm-bound)" in summary and "O5" in summary


def test_cli_kernel_mode(tmp_path, capsys):
    assert main(["--kernel", "gemm", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "VERDICT: O5" in out
    assert (tmp_path / "gemm.jsonl").exists()
    assert main(["--kernel", "spmv", "--out", str(tmp_path)]) == 0
    assert "REJECT" in capsys.readouterr().out


def test_cli_all_frontier_prints_every_kernel(tmp_path, capsys):
    assert main(["--kernel", "all", "--frontier", "--out",
                 str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("VERDICT:") == 8 and out.count("REJECT") == 2
    assert sorted(p.stem for p in tmp_path.glob("*.jsonl")) == NAMES


@pytest.mark.parametrize("argv", [["--serve", "--kernel", "gemm"],
                                  ["--arch", "qwen3-8b"]])
def test_cli_unported_modes_raise_naming_the_roadmap(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP A20"):
        main(argv)


def test_autotuned_gemm_level_is_output_equivalent(rng):
    res = tune("gemm")
    level = OptLevel(res.final.measurement.meta["level"])
    assert level == OptLevel.O5 and level.has(Step.SCRATCHPAD_REORG)
    mod = KERNELS["gemm"]
    inp = mod.make_inputs(rng, 32 / 1024)
    out = mod.run(level, **inp, device="cpu").numpy()
    np.testing.assert_allclose(out, mod.oracle(**inp), rtol=2e-4, atol=1e-5)
