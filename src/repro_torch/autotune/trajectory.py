"""Per-round JSONL trajectories + table rendering for tuning runs (port
copy of ``repro/autotune/trajectory.py``).

One line per round, schema = ``TuneRound.to_dict()`` plus run identity
(target / mode / rejected) — the reference's schema, so one set of
rendering tools reads the trajectories of both packages.  Runs write
under ``experiments/autotune/`` at the repository root unless given
another directory.
"""

from __future__ import annotations

import json
import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "autotune")


def trajectory_path(target: str, out_dir: str = None) -> str:
    d = out_dir or DEFAULT_DIR
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, target.replace("/", "__") + ".jsonl")


def write_trajectory(result, out_dir: str = None, path: str = None) -> str:
    """Write one run's rounds as JSONL (overwrites prior runs of the same
    target: a trajectory is a complete walk, not an append-only log)."""
    path = path or trajectory_path(result.target, out_dir)
    with open(path, "w") as f:
        for rec in result.to_records():
            f.write(json.dumps(rec) + "\n")
    return path


def read_trajectory(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def render_rounds(records: list) -> str:
    """Markdown table of one trajectory (per-round diagnosis + effect)."""
    lines = [
        "| round | state | step applied | dominant | total (s) | "
        "speedup | guideline |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in records:
        m = r["measurement"]
        lines.append(
            f"| {r['round']} | {r['label']} | {r['applied_step'] or '-'} "
            f"| {m['dominant']} | {m['total_s']:.3e} "
            f"| {r['speedup_vs_start']:.1f}x | {r['recommendation']} |")
    return "\n".join(lines)


def render_summary(results: list) -> str:
    """Markdown summary across targets — the paper's Table 4 analog:
    per-kernel chosen steps + modeled speedups + filter verdict."""
    lines = [
        "| target | verdict | rounds | steps chosen (in order) | "
        "final | speedup vs naive |",
        "|---|---|---|---|---|---|",
    ]
    for res in results:
        verdict = "REJECT (comm-bound)" if res.rejected else "accept"
        steps = " -> ".join(res.steps_taken) or "-"
        lines.append(
            f"| {res.target} | {verdict} | {len(res.rounds)} | {steps} "
            f"| {res.final_label} | {res.final_speedup:.1f}x |")
    return "\n".join(lines)
