"""Production training launcher: the port of the JAX package's
`launch/train.py`.

Wires together: config registry -> train state on the device -> resume
from the latest checkpoint -> microbatched train step -> resilient loop
(checkpoint/restore, NaN rollback, straggler monitor). Runs on the card
unless ``--device cpu`` is given; ``--reduced`` only reduces the config
(and computes in f32).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 5 --global-batch 8 --seq 4096 --microbatches 2 \\
        --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 20 --reduced --device cpu --ckpt-dir build/ckpt_cpu

`main(argv)` returns (state, history): the final train-state tree and the
loop's history, with "start_step" (0, or the step it resumed from),
"checkpoints" (the manager's save / restore seconds) and "step_seconds"
(each step's host-clock duration, loss read back included) added.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.core.batch import check_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.runtime import RecoveryPolicy, StepMonitor, run_resilient_loop
from repro_torch.train import init_train_state
from repro_torch.train.train_step import make_train_step, split_microbatches


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="build/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (f32 compute)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def train_functions(args, cfg, device):
    """(data_fn, step_fn) of the launcher: step -> the global batch of
    `TokenPipeline(seed=0)` on `device`, split into microbatches; and
    `make_train_step` with warm-up max(steps // 10, 1), computing in bf16
    (f32 under --reduced)."""
    pipe = TokenPipeline(vocab_size=cfg.vocab_size,
                         batch_size=args.global_batch, seq_len=args.seq,
                         seed=0)
    nm = args.microbatches

    def data_fn(step):
        toks = torch.as_tensor(pipe.batch(step)["tokens"], device=device)
        return split_microbatches(
            {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, nm)

    step_fn = make_train_step(
        cfg, num_microbatches=nm, peak_lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        compute_dtype=torch.float32 if args.reduced else torch.bfloat16)
    return data_fn, step_fn


def main(argv=None):
    args = parse_args(argv)
    device = check_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} d={cfg.d_model} "
          f"devices={n_dev}")

    data_fn, step_fn = train_functions(args, cfg, device)
    manager = CheckpointManager(args.ckpt_dir, keep_last=3)
    state = init_train_state(cfg, 0, device=device).tree()
    start = 0
    if latest_step(args.ckpt_dir) is not None:
        state, meta = manager.restore_latest(state)
        start = int(meta["step"])
        print(f"[train] resumed from step {start}")

    monitor = StepMonitor()
    state, hist = run_resilient_loop(
        state, step_fn, data_fn, num_steps=args.steps, manager=manager,
        policy=RecoveryPolicy(ckpt_every=args.ckpt_every),
        monitor=monitor, start_step=start)
    losses = hist["loss"]
    print(f"[train] done: loss {np.mean(losses[:5]):.3f} -> "
          f"{np.mean(losses[-5:]):.3f}; rollbacks={hist['rollbacks']}")
    hist["start_step"] = start
    hist["checkpoints"] = manager.events
    hist["step_seconds"] = monitor.durations
    return state, hist


if __name__ == "__main__":
    main()
