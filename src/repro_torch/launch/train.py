"""Training entry point (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --steps 200 --seq-len 4096 --global-batch 2 --microbatches 2

runs on the card; ``--reduced --device cpu`` trains the small variant on
the CPU.  The state is drawn from seed 0 on the device, the batches come
from the deterministic pipeline (``data/pipeline.py``, the JAX package's
numbers) through a prefetch thread, and every ``--log-every`` steps it
prints the JAX driver's line: loss, gradient norm, learning rate, tokens/s.

With ``--ckpt-dir D`` it restarts as the JAX driver does: if D holds a
checkpoint, training resumes from its latest step (the batches resume by
step index) and prints ``[restart] resumed from checkpoint step N``, else it
draws a fresh state; every ``--ckpt-every`` steps it saves the state
asynchronously (``checkpoint.Checkpointer``, the JAX package's layout), and
at the end it saves step ``--steps`` and waits for the write.  Kill the
process anywhere and run the command again.  The multi-pod step (a
``--pod-sync`` other than ``gspmd``, one pod) is not ported yet: it raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.train import step as TS


def run(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions = TS.TrainOptions(), device=None,
        steps: int = 100, seed: int = 0, log_every: int = 10,
        log: Callable[[str], None] = print, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50) -> Tuple[Dict, List[Dict]]:
    """Train ``cfg`` up to step ``steps`` on ``shape``'s global batch from a
    state drawn from ``seed``, or from the latest checkpoint in ``ckpt_dir``
    (saved every ``ckpt_every`` steps and at the end, as the JAX driver
    saves); returns (state, one record per step taken).

    A record holds the step's loss, grad_norm and lr, its wall time in ms
    (from a synchronised device to the step's metrics on the host), the
    tokens/s since this run's first step began, and the kernel launches it
    made (``ops.launch_counts``)."""
    dev = resolve_device(device)
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, state = ckpt.restore(TS.abstract_state(cfg), device=dev)
        log(f"[restart] resumed from checkpoint step {start}")
    else:
        state = TS.init_state(cfg, seed, dev)
    train_step = TS.make_train_step(cfg, options)
    tokens = shape.global_batch * shape.seq_len
    records: List[Dict] = []
    with pipeline.Prefetcher(cfg, shape, dev, start_step=start, seed=seed) as feed:
        t0 = time.perf_counter()
        for step_idx, batch in feed:
            if step_idx >= steps:
                break
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            before = ops.launch_counts()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            rec = {k: float(v) for k, v in metrics.items()}  # waits for the step
            now = time.perf_counter()
            after = ops.launch_counts()
            rec.update(step=step_idx + 1, ms=(now - t) * 1e3, tok_s=tokens * (len(records) + 1) / (now - t0),
                       launches={k: after[k] - before[k] for k in after})
            records.append(rec)
            if (step_idx + 1) % log_every == 0:
                log(f"step {step_idx + 1}: loss={rec['loss']:.4f} gnorm={rec['grad_norm']:.3f} "
                    f"lr={rec['lr']:.2e} tok/s={rec['tok_s']:.0f} ms={rec['ms']:.1f}")
            if ckpt and (step_idx + 1) % ckpt_every == 0:
                ckpt.save_async(step_idx + 1, state)
    if ckpt:
        ckpt.save(steps, state)
        ckpt.wait()
        log(f"[ckpt] final checkpoint at step {steps}")
    if records:
        log(f"done: {steps} steps, loss={records[-1]['loss']:.4f}")
    return state, records


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", help="reduced (smoke) config")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: resume from its latest step, save into it")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--pod-sync", default="gspmd", choices=["gspmd", *TS.POD_SYNC_METHODS],
                    help="the pods' gradient sync; only gspmd (one pod) so far, the others raise")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    args = ap.parse_args(argv)

    if args.pod_sync != "gspmd":
        raise NotImplementedError(f"--pod-sync {args.pod_sync}: the launcher trains one pod; the multi-pod step "
                                  "runs through train.step.make_train_step(pod=...) only so far")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    opts = TS.TrainOptions(num_microbatches=args.microbatches, pod_sync=args.pod_sync)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[train] {cfg.name} on {where}: {args.steps} steps of {args.global_batch} x {args.seq_len} tokens "
          f"in {args.microbatches} microbatch(es), remat {opts.remat}")
    state, _ = run(cfg, shape, opts, dev, args.steps, seed=0, log_every=args.log_every,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    return state


if __name__ == "__main__":
    main()
