"""CLI for the closed-loop autotuner.

MachSuite kernels (the paper's analytic model, instant):

  PYTHONPATH=src python -m repro_torch.autotune --kernel gemm
  PYTHONPATH=src python -m repro_torch.autotune --kernel all --frontier

Each run prints the per-round walk and writes a JSONL trajectory under
``experiments/autotune/`` (or ``--out``).  The reference's LM cost-twin
(``--arch``) and serving (``--serve``) modes are still to port and raise
``NotImplementedError`` naming ROADMAP A20.
"""

import argparse
import os
import sys


def _run_one(backend, args):
    from repro_torch.autotune.trajectory import render_rounds, write_trajectory
    from repro_torch.autotune.tuner import autotune

    result = autotune(backend, frontier=args.frontier,
                      max_rounds=args.max_rounds)
    path = write_trajectory(result, out_dir=args.out)
    print(f"== {result.target} ({result.mode}) ==")
    print(render_rounds(result.to_records()))
    if result.rejected:
        print(f"VERDICT: REJECT — {result.target} is communication-bound "
              "(paper Table 5); no refinement attempted")
    else:
        print(f"VERDICT: {result.final_label} via "
              f"{' -> '.join(result.steps_taken) or 'no steps'} "
              f"({result.final_speedup:.1f}x vs start)")
    print(f"trajectory: {os.path.relpath(path)}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.autotune")
    target = ap.add_mutually_exclusive_group(required=True)
    target.add_argument("--kernel",
                        help="MachSuite kernel name, or 'all'")
    target.add_argument("--arch", help="LM architecture (not yet ported)")
    ap.add_argument("--serve", action="store_true",
                    help="walk the serving engine (not yet ported)")
    ap.add_argument("--frontier", action="store_true",
                    help="AutoDSE-style mode: measure every remaining "
                         "candidate step per round, keep the best")
    ap.add_argument("--max-rounds", type=int, default=12)
    ap.add_argument("--out", default=None,
                    help="trajectory dir (default experiments/autotune)")
    args = ap.parse_args(argv)

    if args.serve or args.arch:
        raise NotImplementedError(
            "the serving walk (--serve) and the LM cost twin (--arch) need "
            "ServingBackend and CostTwinBackend, which the port does not "
            "have yet (ROADMAP A20)")

    from repro_torch.autotune.measurement import KernelModelBackend
    from repro_torch.core.costmodel import MACHSUITE_PROFILES

    names = (sorted(MACHSUITE_PROFILES) if args.kernel == "all"
             else [args.kernel])
    for name in names:
        if name not in MACHSUITE_PROFILES:
            ap.error(f"unknown kernel {name!r}; "
                     f"choices: {', '.join(sorted(MACHSUITE_PROFILES))}")
        _run_one(KernelModelBackend(MACHSUITE_PROFILES[name]), args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
