"""End-to-end training driver (port of ``repro/launch/train.py`` for one
device).

Wires config -> training step (``steps.py``) -> deterministic
double-buffered data pipeline -> AdamW -> async checkpointing ->
resilient step loop (retry / restore / straggler accounting):

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 5 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 5 --batch 8 --seq 4096

Without ``--smoke``, ``--batch`` and ``--seq`` override the ``--shape``
cell's global batch and sequence length (the reference ignores them
there; one card does not hold train_4k's batch of 256).
``--overlap-grad-sync`` and ``--compress-grads`` act on the cross-pod
gradient reduction, which one device does not have: as in the reference
on a mesh without a pod axis, they are no-ops and say so.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import steps as steps_lib
from repro_torch.runtime import ResilientRunner
from repro_torch.tree import map_tree


def train(cfg, shape, *, steps: int = 20, ckpt_dir: str = None,
          ckpt_every: int = 10, seed: int = 0, device=None,
          overlap_grad_sync: bool = False, compress_grads: bool = False,
          log_every: int = 1, resume: bool = True) -> dict:
    """Train ``steps`` steps of ``cfg`` on batches of ``shape`` on one
    device (``None`` = CUDA), resuming from the latest checkpoint in
    ``ckpt_dir`` when there is one.  Returns the losses and per-step
    metrics, the step count and wall time, the runner's events and the
    final params."""
    art = steps_lib.build_train(cfg, shape, device=device)
    dev = art.model.device
    if overlap_grad_sync or compress_grads:
        print("[train] no pod axis in mesh; overlap/compression knobs "
              "are no-ops on this mesh")

    params = art.init_params(torch.Generator(device=dev).manual_seed(seed))
    opt = art.init_opt(params)
    # Shapes and dtypes of the state for restores; holds no memory (a
    # restore must not keep the initial state alive for the whole run).
    spec = map_tree(lambda t: torch.empty_like(t, device="meta"),
                    {"params": params, "opt": opt})

    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    start_step = 0
    if mgr is not None and resume:
        restored = mgr.restore_latest(spec, device=dev)
        if restored is not None:
            tree, start_step, _ = restored
            params, opt = tree["params"], tree["opt"]
            print(f"[train] restored checkpoint at step {start_step}")

    pipe = make_pipeline(cfg, shape, seed=seed, start_step=start_step,
                         device=dev)
    losses, metrics_log = [], []

    def one_step(state, step):
        params, opt = state
        batch = pipe.get(step)
        params, opt, metrics = art.step_fn(params, opt, batch)
        if step % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            losses.append((step, m["loss"]))
            metrics_log.append({"step": step, **m})
            print(f"[train] step {step:5d} loss {m['loss']:.4f} grad_norm "
                  f"{m['grad_norm']:.4g} lr {m['lr']:.3e}", flush=True)
        return params, opt

    def save(state, step):
        if mgr is not None:
            mgr.save_async({"params": state[0], "opt": state[1]}, step=step)

    def restore():
        nonlocal pipe
        if mgr is None:
            return None
        mgr.wait()
        restored = mgr.restore_latest(spec, device=dev)
        if restored is None:
            return None
        tree, step, _ = restored
        pipe.close()
        pipe = make_pipeline(cfg, shape, seed=seed, start_step=step,
                             device=dev)
        return (tree["params"], tree["opt"]), step

    runner = ResilientRunner(one_step, save_fn=save, restore_fn=restore,
                             every=ckpt_every)
    # The runner gets the only reference to the initial state, so the
    # state of each step frees the last one's.
    box = [(params, opt)]
    del params, opt
    t0 = time.time()
    try:
        (params, opt), end_step = runner.run(
            box.pop(), start_step=start_step, n_steps=steps)
        wall = time.time() - t0
        if mgr is not None:
            mgr.save_async({"params": params, "opt": opt}, step=end_step)
    finally:
        pipe.close()
        if mgr is not None:
            mgr.close()
    return {
        "losses": losses,
        "metrics": metrics_log,
        "steps": end_step - start_step,
        "wall_s": wall,
        "step_s": list(runner.step_times),
        "events": runner.events,
        "params": params,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_NAMES)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default: 8 with --smoke, else the "
                         "shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length (default: 128 with --smoke, else "
                         "the shape's)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--overlap-grad-sync", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = get_smoke(args.arch)
        shape = ShapeConfig("smoke_train", args.seq or 128, args.batch or 8,
                            "train")
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
        shape = dataclasses.replace(
            shape, seq_len=args.seq or shape.seq_len,
            global_batch=args.batch or shape.global_batch)

    out = train(cfg, shape, steps=args.steps, ckpt_dir=args.ckpt,
                ckpt_every=args.ckpt_every, seed=args.seed,
                device=args.device,
                overlap_grad_sync=args.overlap_grad_sync,
                compress_grads=args.compress_grads)
    first = out["losses"][0][1] if out["losses"] else float("nan")
    last = out["losses"][-1][1] if out["losses"] else float("nan")
    print(f"[train] {out['steps']} steps in {out['wall_s']:.1f}s   "
          f"loss {first:.4f} -> {last:.4f}")


if __name__ == "__main__":
    main()
