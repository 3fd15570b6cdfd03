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
process anywhere and run the command again.

``--multi-pod`` with a Hoplite ``--pod-sync`` (``hoplite_chain``,
``hoplite_2d``, ``psum``) trains as many pods as the pod axis of
``make_debug_mesh(multi_pod=True)`` has (2), each a rank process
(``core.group.run_ranks``) on the same device with a replica of the state;
the gradients cross the pods through that sync every step.  Each pod runs
on one device (``--devices`` is not ported), so its mesh is
``pod_mesh(pods)``, (pods, 1, 1) over (pod, data, model), and it takes the
block of each global batch that ``partitioning.batch_specs``' placements
give its pod coordinate: rows of dim 0 of ``tokens``, ``labels`` and
``encoder_frames``, of dim 1 of ``positions_3d``.  (On the debug mesh's
(2, 2, 2) a batch that the 4 devices of (pod, data) do not divide, such as
2 rows, is replicated over the pods by the JAX package's rule, which drops
the pod axis first; on (2, 1, 1) each pod takes one row.)  With
``--ckpt-dir`` rank 0 writes the checkpoints, every rank restores from
them, and the logs come from rank 0.  After every step each pod hashes its
state (``state_digest``); the run fails if the pods' hashes differ.
``--multi-pod --pod-sync gspmd`` raises ``NotImplementedError``: that
reduction belongs to the partitioner within a pod, which the port lacks.
A Hoplite ``--pod-sync`` without ``--multi-pod`` trains one pod, as the
JAX step does on a mesh with no pod axis.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import Checkpointer, named_leaves
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import group as G
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import POD_AXES, AbstractMesh, debug_mesh_shape
from repro_torch.sharding import partitioning
from repro_torch.train import step as TS

# Wall-clock seconds a multi-pod run may take, on top of RANK_STEP_S a step.
RANK_START_S = 600.0
RANK_STEP_S = 60.0

# 32-bit words a leaf's checksum takes at a time, and the prime it is taken modulo.
_DIGEST_CHUNK = 1 << 25
_DIGEST_PRIME = 2_147_483_647


def pod_mesh(pods: int) -> AbstractMesh:
    """The mesh a multi-pod run trains on: ``pods`` pods of one device each."""
    return AbstractMesh((pods, 1, 1), POD_AXES)


def pod_share(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions, mesh, pod: int,
              batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pod ``pod``'s block of a global host batch: each array's slice at pod
    coordinate ``pod`` (the other coordinates 0) under the placements of
    ``partitioning.batch_specs`` on ``mesh``."""
    specs = partitioning.batch_specs(cfg, mesh, shape, options.sharding)
    coord = [pod if name == "pod" else 0 for name in mesh.mesh_dim_names]
    return {k: a[partitioning.local_slices(a.shape, partitioning.placements(specs[k], mesh), mesh, coord)]
            for k, a in batch.items()}


def _checksums(t: torch.Tensor) -> Tuple[int, int]:
    """Two checksums of a tensor's bytes, read as 32-bit words w_i on its own
    device: sum of w_i * (2i + 1) and sum of w_i^2, each mod a prime."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    w = b.view(torch.int32)
    s1 = s2 = 0
    for i in range(0, w.numel(), _DIGEST_CHUNK):
        x = w[i:i + _DIGEST_CHUNK].long()
        odd = torch.arange(i, i + x.numel(), device=x.device, dtype=torch.int64) * 2 + 1
        s1 = (s1 + int(torch.remainder(x * odd, _DIGEST_PRIME).sum())) % _DIGEST_PRIME
        s2 = (s2 + int(torch.remainder(x * x, _DIGEST_PRIME).sum())) % _DIGEST_PRIME
    return s1, s2


def state_digest(tree) -> str:
    """A hash of every leaf's bytes: sha256 over each leaf's path, type,
    shape and ``_checksums``.  Two replicas that differ in one word of one
    leaf hash differently."""
    h = hashlib.sha256()
    for name, t in named_leaves(tree):
        h.update(repr((name, str(t.dtype), tuple(t.shape), _checksums(t))).encode())
    return h.hexdigest()[:16]


def _train(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions, dev: torch.device, steps: int,
           seed: int, log_every: int, log: Callable[[str], None], ckpt_dir: Optional[str], ckpt_every: int,
           pod=None, share=None, writes: bool = True) -> Tuple[Dict, List[Dict]]:
    """The training loop of one process: a single pod, or one rank of the
    ``pod`` group that takes ``share`` of each global batch.  Only a process
    that ``writes`` saves checkpoints."""
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        start, state = ckpt.restore(TS.abstract_state(cfg), device=dev)
        log(f"[restart] resumed from checkpoint step {start}")
    else:
        state = TS.init_state(cfg, seed, dev)
    if not writes:
        ckpt = None
    train_step = TS.make_train_step(cfg, options, pod=pod)
    tokens = shape.global_batch * shape.seq_len
    records: List[Dict] = []
    with pipeline.Prefetcher(cfg, shape, dev, start_step=start, seed=seed, share=share) as feed:
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
            if pod is not None:
                rec.update(sync_ms=train_step.sync_seconds[-1] * 1e3, digest=state_digest(state),
                           peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
            records.append(rec)
            if (step_idx + 1) % log_every == 0:
                sync = f" sync_ms={rec['sync_ms']:.1f}" if pod is not None else ""
                log(f"step {step_idx + 1}: loss={rec['loss']:.4f} gnorm={rec['grad_norm']:.3f} "
                    f"lr={rec['lr']:.2e} tok/s={rec['tok_s']:.0f} ms={rec['ms']:.1f}{sync}")
            if ckpt and (step_idx + 1) % ckpt_every == 0:
                ckpt.save_async(step_idx + 1, state)
    if ckpt:
        ckpt.save(steps, state)
        ckpt.wait()
        log(f"[ckpt] final checkpoint at step {steps}")
    if records:
        log(f"done: {steps} steps, loss={records[-1]['loss']:.4f}")
    return state, records


def _pod_rank(dev: torch.device, cfg, shape, options, steps, seed, log_every, ckpt_dir, ckpt_every,
              return_state: bool):
    """One pod of a multi-pod run, in a rank process of ``run_ranks``."""
    r, n = dist.get_rank(), dist.get_world_size()
    lines: List[str] = []
    share = functools.partial(pod_share, cfg, shape, options, pod_mesh(n), r)
    state, records = _train(cfg, shape, options, dev, steps, seed, log_every,
                            lines.append if r == 0 else (lambda _: None), ckpt_dir, ckpt_every,
                            pod=dist.group.WORLD, share=share, writes=r == 0)
    return {"records": records, "log": lines, "state": state if return_state else None}


def run(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions = TS.TrainOptions(), device=None,
        steps: int = 100, seed: int = 0, log_every: int = 10,
        log: Callable[[str], None] = print, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50, pods: int = 1, return_state: bool = True) -> Tuple[Optional[Dict], List[Dict]]:
    """Train ``cfg`` up to step ``steps`` on ``shape``'s global batch from a
    state drawn from ``seed``, or from the latest checkpoint in ``ckpt_dir``
    (saved every ``ckpt_every`` steps and at the end, as the JAX driver
    saves); returns (state, one record per step taken).

    A record holds the step's loss, grad_norm and lr, its wall time in ms
    (from a synchronised device to the step's metrics on the host), the
    tokens/s since this run's first step began, and the kernel launches it
    made (``ops.launch_counts``).

    With ``pods`` > 1 the pods are rank processes (see the module's
    docstring); the records are rank 0's, and each also holds ``digests``,
    every pod's ``state_digest`` after the step, and ``pods``, every pod's
    ms, sync_ms (the sync's share of ms), launches and peak device bytes so
    far.  Rank 0's log lines are passed to ``log`` when the ranks are done.
    The state (rank 0's, on the CPU) comes back only with ``return_state``;
    otherwise it is ``None``.  Raises if the pods' digests differ."""
    dev = resolve_device(device)
    if pods == 1:
        return _train(cfg, shape, options, dev, steps, seed, log_every, log, ckpt_dir, ckpt_every)
    out = G.run_ranks(_pod_rank, pods, dev, cfg, shape, options, steps, seed, log_every, ckpt_dir, ckpt_every,
                      return_state, timeout=RANK_START_S + RANK_STEP_S * steps)
    for line in out[0]["log"]:
        log(line)
    records = out[0]["records"]
    for i, rec in enumerate(records):
        ranks = [o["records"][i] for o in out]
        rec["digests"] = [r.pop("digest") for r in ranks]
        rec["pods"] = [{k: r[k] for k in ("ms", "sync_ms", "launches", "peak_bytes")} for r in ranks]
        if len(set(rec["digests"])) != 1:
            raise RuntimeError(f"step {rec['step']}: the pods' replicas differ: digests {rec['digests']}")
    return out[0]["state"], records


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
                    help="the pods' gradient sync: a Hoplite method with --multi-pod")
    ap.add_argument("--multi-pod", action="store_true",
                    help="train the debug mesh's pods, each a rank process with a replica")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    args = ap.parse_args(argv)

    if args.multi_pod and args.pod_sync not in TS.POD_SYNC_METHODS:
        raise NotImplementedError(
            f"--multi-pod --pod-sync {args.pod_sync}: the pods' gradients would reduce through the partitioner "
            f"within a pod (GSPMD), which the port lacks; use one of {sorted(TS.POD_SYNC_METHODS)}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    opts = TS.TrainOptions(num_microbatches=args.microbatches, pod_sync=args.pod_sync)
    pods = partitioning.mesh_axes(debug_mesh_shape(multi_pod=True))["pod"] if args.multi_pod else 1
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    across = f", {pods} pods synced by {args.pod_sync}" if pods > 1 else ""
    print(f"[train] {cfg.name} on {where}: {args.steps} steps of {args.global_batch} x {args.seq_len} tokens "
          f"in {args.microbatches} microbatch(es), remat {opts.remat}{across}")
    state, records = run(cfg, shape, opts, dev, args.steps, seed=0, log_every=args.log_every,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, pods=pods, return_state=pods == 1)
    if pods > 1 and records:
        print(f"[pods] {pods} replicas bit for bit the same after every step; step {records[-1]['step']} "
              f"digest {records[-1]['digests'][0]}")
    return state


if __name__ == "__main__":
    main()
