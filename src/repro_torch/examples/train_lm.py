"""Train a ~100M-parameter LM for a few hundred steps on a (2, 2) mesh, with
a simulated crash and a restart from the checkpoint (port of
``examples/train_lm.py``).

A qwen3-family config scaled to ~100M parameters, trained on the
deterministic synthetic pipeline's learnable stream (``structured=True``)
with the production train step: FSDP x TP on a (data 2, model 2) mesh of 4
rank processes that share the device (``core.group.run_ranks`` with the
``staged`` backend), async checkpoints every 50 steps.  At ``--crash-at`` the
ranks end, as a lost process would, and new ranks resume from the latest
checkpoint by step index.  The loss must fall.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import group as G
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import metric_value
from repro_torch.models.common import param_elems
from repro_torch.models.transformer import model_skel
from repro_torch.sharding import partitioning, placement
from repro_torch.train import step as TS

MESH = ((2, 2), ("data", "model"))
SHAPE = ShapeSpec("lm100m", seq_len=64, global_batch=4, kind="train")


def lm_100m(layers: int = 12):
    """qwen3-family config at ~100M params (12L x 512 x 8H, vocab 8k); ``layers`` cuts its depth."""
    return dataclasses.replace(get_config("qwen3-14b"), name="qwen3-100m", num_layers=layers, d_model=512, num_heads=8,
                               num_kv_heads=4, d_ff=2048, vocab_size=8192, head_dim=64, dtype="float32",
                               param_dtype="float32")


def options(steps: int, warmup: int) -> TS.TrainOptions:
    return TS.TrainOptions(num_microbatches=1,
                           adamw=dataclasses.replace(TS.TrainOptions().adamw, lr=1e-3, warmup_steps=warmup,
                                                     total_steps=steps))


def _run_until(dev: torch.device, stop_step: int, steps: int, warmup: int, ckpt_dir: str,
               layers: int) -> Dict[str, list]:
    """One rank: (re)start from the latest checkpoint and train up to
    ``stop_step``; its losses, and rank 0's log lines."""
    cfg, opts = lm_100m(layers), options(steps, warmup)
    mesh = make_mesh(*MESH, dev)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size()))
    lines: List[str] = []
    log = lines.append if dist.get_rank() == 0 else (lambda _: None)
    ckpt = Checkpointer(ckpt_dir)
    start = 0
    if ckpt.latest_step() is not None:
        where = placement.shardings(TS.state_specs(cfg, mesh, opts), mesh)
        start, state = ckpt.restore(TS.abstract_state(cfg), placements=where)
        log(f"[restart] resumed at step {start}")
    else:
        state = TS.init_state(cfg, 0, dev, mesh=mesh, options=opts)
    train_step = TS.make_train_step(cfg, opts)
    specs = partitioning.batch_specs(cfg, mesh, SHAPE, opts.sharding)
    losses = []
    t0 = time.time()
    for step_idx in range(start, stop_step):
        batch = pipeline.device_batch(cfg, SHAPE, step_idx, dev, structured=True, mesh=mesh, specs=specs)
        state, metrics = train_step(state, batch)
        losses.append(metric_value(metrics["loss"]))
        if (step_idx + 1) % 25 == 0:
            tokps = (step_idx + 1 - start) * SHAPE.global_batch * SHAPE.seq_len / (time.time() - t0)
            log(f"  step {step_idx + 1}: loss={losses[-1]:.4f} tok/s={tokps:.0f}")
        if (step_idx + 1) % 50 == 0:
            ckpt.save_async(step_idx + 1, state)
    ckpt.save(stop_step, state)
    ckpt.wait()
    return {"losses": losses, "log": lines}


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--crash-at", type=int, default=120, help="simulate a failure at this step (0 = off)")
    ap.add_argument("--warmup-steps", type=int, default=30)
    ap.add_argument("--layers", type=int, default=12, help="cut the depth (a quick run)")
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = lm_100m(args.layers)
    print(f"model: {cfg.name}, {param_elems(model_skel(cfg)) / 1e6:.1f}M params, mesh {dict(zip(*MESH[::-1]))} "
          f"as {MESH[0][0] * MESH[0][1]} rank processes on {dev.type}")
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    n = MESH[0][0] * MESH[0][1]

    def run_until(stop: int) -> List[float]:
        """New rank processes, from the latest checkpoint to ``stop``."""
        out = G.run_ranks(_run_until, n, dev, stop, args.steps, args.warmup_steps, args.ckpt_dir, args.layers,
                          timeout=600.0 + 60.0 * args.steps)[0]
        for line in out["log"]:
            print(line)
        return out["losses"]

    if args.crash_at and args.crash_at < args.steps:
        losses = run_until(args.crash_at)
        print(f"[crash] simulating process loss at step {args.crash_at}")
        losses += run_until(args.steps)
    else:
        losses = run_until(args.steps)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps "
          f"(must decrease on a learnable synthetic stream)")
    assert losses[-1] < losses[0], "loss did not improve"
    print("train_lm OK")
    return losses


if __name__ == "__main__":
    main()
