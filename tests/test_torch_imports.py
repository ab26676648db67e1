"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package; importing
the whole port loads neither; and entry points run on the CUDA device
unless the caller asks for the CPU — without CUDA they raise instead of
falling back."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_no_module_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import serve_demo
    from repro_torch.models import get_model
    from repro_torch.models.bridge import params_from_jax

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("qwen3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_demo(cfg, batch_size=2, max_seq=16, n_requests=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({})
    assert resolve_device("cpu").type == "cpu"
    assert get_model(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_cuda():
    """The card check refuses to run, and prints no result, on a machine
    without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_train_entry_points_default_to_cuda_and_never_fall_back(
        monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.steps import build_train
    from repro_torch.launch.train import train
    from repro_torch.models import make_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("smollm-360m")
    shape = ShapeConfig("t", 16, 2, "train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_train(cfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, shape, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pipeline(cfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch(cfg, shape, torch.Generator())
    assert build_train(cfg, shape, device="cpu").model.device.type == "cpu"


def test_the_scan_covers_the_paper_layer():
    mods = set(_modules())
    assert {"repro_torch.core.hw", "repro_torch.core.costmodel",
            "repro_torch.core.guideline", "repro_torch.autotune",
            "repro_torch.autotune.__main__",
            "repro_torch.autotune.measurement", "repro_torch.autotune.tuner",
            "repro_torch.autotune.trajectory", "repro_torch.machsuite",
            "repro_torch.machsuite.common", "repro_torch.machsuite.gemm",
            "repro_torch.kernels.tiled_matmul.kernel",
            "repro_torch.kernels.tiled_matmul.ops",
            "repro_torch.kernels.tiled_matmul.ref"} <= mods


def test_paper_layer_defaults_to_cuda_and_never_falls_back(monkeypatch):
    import numpy as np

    from repro_torch.kernels.tiled_matmul import ops as mops
    from repro_torch.machsuite import gemm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = gemm.make_inputs(np.random.default_rng(0), 32 / 1024)
    for level in range(6):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gemm.run(level, **inp)
    assert gemm.run(5, **inp, device="cpu").device.type == "cpu"
    # CPU tensors take the plain versions and launch no kernel.
    a = torch.ones(32, 32)
    counts = (mops.matmul_whole.launches, mops.matmul_tiled.launches)
    for level in range(6):
        assert torch.equal(mops.matmul(a, a, level),
                           torch.full((32, 32), 32.0))
    assert (mops.matmul_whole.launches, mops.matmul_tiled.launches) == counts


def test_the_scan_covers_the_serving_front_end():
    mods = set(_modules())
    assert {"repro_torch.launch.server", "repro_torch.launch.serve",
            "repro_torch.serving.engine", "repro_torch.serving.cache",
            "repro_torch.serving.paged",
            "repro_torch.autotune.measurement",
            "repro_torch.autotune.__main__"} <= mods


def test_serving_walk_defaults_to_cuda_and_never_falls_back(monkeypatch):
    from repro_torch.autotune import ServingBackend
    from repro_torch.autotune.__main__ import main
    from repro_torch.core.optlevel import OptLevel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingBackend().measure(OptLevel.O0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--serve", "--arch", "qwen3-8b"])
