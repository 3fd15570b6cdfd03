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

``--devices 8`` runs the JAX launcher's partitioned step: the debug mesh,
(data 4, model 2), as 8 rank processes (``core.group.run_ranks`` with the
``staged`` backend) that share the one device.  The state is placed by
``train.step.state_specs`` (rank 0 draws each parameter, from the same
stream as one process, and sends every rank its block), each rank builds
only its rows of every batch (``partitioning.batch_specs``), and the step is
``make_train_step`` on those DTensors, whose collectives DTensor issues op by
op.  ``--multi-pod`` makes the mesh (pod 2, data 2, model 2): with
``--pod-sync gspmd`` the step runs on the whole mesh and DTensor reduces over
the pod axis; with a Hoplite ``--pod-sync`` each pod's state lies on its
(data, model) sub-mesh and the gradients cross the pods through that sync on
each device's local block (``chunk_reduce`` on the card).  After every step
each rank hashes its blocks (``state_digest``), and the run fails if two
pods' ranks at the same (data, model) coordinate differ.  Checkpoints are
gathered to rank 0, which writes them; every rank reads its own blocks back.
Every block of the state and of each batch is checked to lie on the device.
The default is ``--devices 1`` (the JAX launcher's is 8): one process, as
before.

``--multi-pod`` with ``--devices 1`` and a Hoplite ``--pod-sync``
(``hoplite_chain``, ``hoplite_2d``, ``psum``) trains as many pods as the pod
axis of ``make_debug_mesh(multi_pod=True)`` has (2), each a rank process
with a replica of the state on the same device; the gradients cross the
pods through that sync every step.  Each pod runs on one device, so its
mesh is ``pod_mesh(pods)``, (pods, 1, 1) over (pod, data, model), and it
takes the block of each global batch that ``partitioning.batch_specs``'
placements give its pod coordinate: rows of dim 0 of ``tokens``, ``labels``
and ``encoder_frames``, of dim 1 of ``positions_3d``.  (On the debug mesh's
(2, 2, 2) a batch that the 4 devices of (pod, data) do not divide, such as
2 rows, is replicated over the pods by the JAX package's rule, which drops
the pod axis first; on (2, 1, 1) each pod takes one row.)  With
``--ckpt-dir`` rank 0 writes the checkpoints, every rank restores from
them, and the logs come from rank 0.  After every step each pod hashes its
state (``state_digest``); the run fails if the pods' hashes differ.
``--multi-pod --pod-sync gspmd`` needs the mesh (``--devices 8``): with one
device a pod there is no partitioner within a pod to reduce over the pods.
A Hoplite ``--pod-sync`` without ``--multi-pod`` trains one pod, as the
JAX step does on a mesh with no pod axis.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpoint import Checkpointer, named_leaves
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import group as G
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import POD_AXES, AbstractMesh, debug_mesh_shape, make_mesh
from repro_torch.sharding import partitioning, placement
from repro_torch.train import step as TS
from repro_torch.tree import tree_map

# Wall-clock seconds a multi-pod run may take, on top of RANK_STEP_S a step
# (MESH_STEP_S on a mesh, whose collectives cross the host op by op).
RANK_START_S = 600.0
RANK_STEP_S = 60.0
MESH_STEP_S = 600.0

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


def local_blocks(tree):
    """``tree`` with each DTensor replaced by its local block."""
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def param_samples(params, n: int, seed: int = 0) -> Optional[Dict[str, np.ndarray]]:
    """Up to ``n`` elements of each parameter, as f32 on the host, at flat
    indices drawn from ``seed`` and the leaf's place in the tree, so that a
    run on a mesh and one process sample the same elements.  A DTensor leaf
    is gathered whole on rank 0 one leaf at a time (every rank must call);
    ``None`` on the other ranks."""
    out: Dict[str, np.ndarray] = {}
    for i, (name, t) in enumerate(named_leaves(params)):
        numel = math.prod(t.shape)
        idx = np.arange(numel) if numel <= n else np.unique(np.random.default_rng([seed, i]).integers(0, numel, n))
        whole = placement.gather_to_root(t) if isinstance(t, DTensor) else t.detach()
        if whole is not None:
            flat = whole.reshape(-1)
            out[name] = flat[torch.from_numpy(idx).to(flat.device)].float().cpu().numpy()
        del whole
    return out if not dist.is_initialized() or dist.get_rank() == 0 else None


def metric_value(v) -> float:
    """A metric of the step as a float: a DTensor's whole value (a partial
    sum reduced), not its local block."""
    return float(v.full_tensor() if isinstance(v, DTensor) else v)


def _train(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions, dev: torch.device, steps: int,
           seed: int, log_every: int, log: Callable[[str], None], ckpt_dir: Optional[str], ckpt_every: int,
           pod=None, share=None, writes: bool = True, mesh=None, samples: int = 0) -> Tuple[Dict, List[Dict]]:
    """The training loop of one process: a single pod, one rank of the
    ``pod`` group that takes ``share`` of each global batch, or one rank of
    ``mesh`` (a DeviceMesh), whose state and batches are placed on it.  Only
    a process that ``writes`` saves checkpoints (on a mesh every rank takes
    part in a save, and rank 0 writes).  With ``samples``, the last record
    holds ``param_samples`` of the final parameters (rank 0's)."""
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    on = specs = None
    if mesh is not None:
        on = TS.state_mesh(mesh, options)
        specs = partitioning.batch_specs(cfg, mesh, shape, options.sharding)
        if pod is None and on is not mesh:
            pod = mesh.get_group("pod")
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        where = None if mesh is None else placement.shardings(TS.state_specs(cfg, mesh, options), mesh, on)
        start, state = ckpt.restore(TS.abstract_state(cfg), device=dev, placements=where)
        log(f"[restart] resumed from checkpoint step {start}")
    else:
        state = TS.init_state(cfg, seed, dev, mesh=mesh, options=options)
    placement.check_tree_on(state, dev)
    if mesh is not None and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)  # the steps' peak, not the placing's (rank 0 holds whole leaves)
    if not writes:
        ckpt = None
    train_step = TS.make_train_step(cfg, options, pod=pod)
    tokens = shape.global_batch * shape.seq_len
    records: List[Dict] = []
    with pipeline.Prefetcher(cfg, shape, dev, start_step=start, seed=seed, share=share, mesh=mesh, specs=specs,
                             on=on) as feed:
        t0 = time.perf_counter()
        for step_idx, batch in feed:
            if step_idx >= steps:
                break
            placement.check_tree_on(batch, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            before = ops.launch_counts()
            G.reset_collective_counts()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            rec = {k: metric_value(v) for k, v in metrics.items()}  # waits for the step
            now = time.perf_counter()
            after = ops.launch_counts()
            rec.update(step=step_idx + 1, ms=(now - t) * 1e3, tok_s=tokens * (len(records) + 1) / (now - t0),
                       launches={k: after[k] - before[k] for k in after})
            if pod is not None or mesh is not None:
                rec.update(digest=state_digest(local_blocks(state)), collectives=G.collective_counts(),
                           peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
            if pod is not None:
                rec["sync_ms"] = train_step.sync_seconds[-1] * 1e3
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
    if samples and records:
        got = param_samples(state["params"], samples, seed)
        if got is not None:
            records[-1]["param_samples"] = got
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


def gather_state(state):
    """A placed state whole on rank 0's host, leaf by leaf (``None`` elsewhere)."""
    whole = tree_map(placement.gather_to_root, state)
    return whole if dist.get_rank() == 0 else None


def _mesh_rank(dev: torch.device, cfg, shape, options, steps, seed, log_every, ckpt_dir, ckpt_every,
               mesh_shape: AbstractMesh, return_state: bool, samples: int):
    """One rank of a run on a mesh, in a rank process of ``run_ranks``."""
    mesh = make_mesh(mesh_shape.shape, mesh_shape.mesh_dim_names, dev)
    r = dist.get_rank()
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size()))
    lines: List[str] = []
    state, records = _train(cfg, shape, options, dev, steps, seed, log_every,
                            lines.append if r == 0 else (lambda _: None), ckpt_dir, ckpt_every, mesh=mesh,
                            samples=samples)
    whole = gather_state(state) if return_state else None
    return {"records": records, "log": lines, "state": whole, "coordinate": mesh.get_coordinate()}


def mesh_for(devices: int, multi_pod: bool = False) -> AbstractMesh:
    """The mesh ``--devices`` trains on: the debug mesh, whose size it must be."""
    shape = debug_mesh_shape(multi_pod=multi_pod)
    if devices != shape.size():
        raise ValueError(f"--devices {devices}: the debug mesh {dict(zip(shape.mesh_dim_names, shape.shape))} "
                         f"has {shape.size()}")
    return shape


def _pods_agree(records: List[Dict], coords: List[Tuple[int, ...]], names: Tuple[str, ...]) -> None:
    """Raise unless every rank's digest equals those of the ranks at its
    (data, model) coordinate in the other pods, after every step."""
    if "pod" not in names:
        return
    keep = [i for i, n in enumerate(names) if n != "pod"]
    for rec in records:
        by_place: Dict[Tuple, set] = {}
        for c, d in zip(coords, rec["digests"]):
            by_place.setdefault(tuple(c[j] for j in keep), set()).add(d)
        if any(len(v) != 1 for v in by_place.values()):
            raise RuntimeError(f"step {rec['step']}: the pods' blocks differ: digests {rec['digests']}")


def run_mesh(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions, dev: torch.device, steps: int,
             seed: int, log_every: int, log: Callable[[str], None], ckpt_dir: Optional[str], ckpt_every: int,
             mesh_shape: AbstractMesh, return_state: bool, samples: int = 0) -> Tuple[Optional[Dict], List[Dict]]:
    """``run`` on ``mesh_shape``'s ranks (see ``run``)."""
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()  # once here, not in every rank at once
    out = G.run_ranks(_mesh_rank, mesh_shape.size(), dev, cfg, shape, options, steps, seed, log_every, ckpt_dir,
                      ckpt_every, mesh_shape, return_state, samples, timeout=RANK_START_S + MESH_STEP_S * steps)
    for line in out[0]["log"]:
        log(line)
    records = out[0]["records"]
    for i, rec in enumerate(records):
        ranks = [o["records"][i] for o in out]
        rec["digests"] = [r.pop("digest") for r in ranks]
        rec["ranks"] = [{k: r[k] for k in ("ms", "launches", "peak_bytes", "collectives", "loss", "grad_norm",
                                           "sync_ms") if k in r} for r in ranks]
    _pods_agree(records, [o["coordinate"] for o in out], mesh_shape.mesh_dim_names)
    return out[0]["state"], records


def run(cfg: ModelConfig, shape: ShapeSpec, options: TS.TrainOptions = TS.TrainOptions(), device=None,
        steps: int = 100, seed: int = 0, log_every: int = 10,
        log: Callable[[str], None] = print, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50, pods: int = 1, return_state: bool = True,
        mesh: Optional[AbstractMesh] = None, samples: int = 0) -> Tuple[Optional[Dict], List[Dict]]:
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
    otherwise it is ``None``.  Raises if the pods' digests differ.

    With ``mesh`` (an ``AbstractMesh``: ``mesh_for(8)``) the step runs
    partitioned over that many rank processes (the module's docstring); the
    records are rank 0's (metrics reduced over the mesh), each also holding
    ``digests``, every rank's ``state_digest`` of its blocks, and ``ranks``,
    every rank's ms, launches, peak device bytes, staged collectives
    (``group.collective_counts``: calls, bytes, seconds by kind) and, under
    a Hoplite pod sync, sync_ms.  The state comes back whole on the CPU with
    ``return_state``.  Raises if two pods' blocks differ.

    With ``samples`` (one process or a mesh), the last record also holds
    ``param_samples``: that many elements of each final parameter, at
    indices drawn from ``seed``, to hold a run's update against another's."""
    dev = resolve_device(device)
    if mesh is not None:
        return run_mesh(cfg, shape, options, dev, steps, seed, log_every, log, ckpt_dir, ckpt_every, mesh,
                        return_state, samples)
    if pods == 1:
        return _train(cfg, shape, options, dev, steps, seed, log_every, log, ckpt_dir, ckpt_every, samples=samples)
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
    ap.add_argument("--devices", type=int, default=1,
                    help="rank processes sharing the device: 1, or the debug mesh's 8 (the JAX launcher's default)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    args = ap.parse_args(argv)

    if args.devices == 1 and args.multi_pod and args.pod_sync not in TS.POD_SYNC_METHODS:
        raise NotImplementedError(
            f"--multi-pod --pod-sync {args.pod_sync} with one device a pod: the pods' gradients reduce through "
            f"the partitioner within a pod, which runs on the mesh (--devices 8); or use one of "
            f"{sorted(TS.POD_SYNC_METHODS)}")
    mesh = mesh_for(args.devices, args.multi_pod) if args.devices > 1 else None
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    shape = ShapeSpec("cli", args.seq_len, args.global_batch, "train")
    opts = TS.TrainOptions(num_microbatches=args.microbatches, pod_sync=args.pod_sync)
    pods = partitioning.mesh_axes(debug_mesh_shape(multi_pod=True))["pod"] if args.multi_pod else 1
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    across = f", {pods} pods synced by {args.pod_sync}" if pods > 1 else ""
    if mesh is not None:
        across = (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} as {args.devices} rank processes"
                  + (f", the pods synced by {args.pod_sync}" if args.multi_pod else ""))
    print(f"[train] {cfg.name} on {where}: {args.steps} steps of {args.global_batch} x {args.seq_len} tokens "
          f"in {args.microbatches} microbatch(es), remat {opts.remat}{across}")
    state, records = run(cfg, shape, opts, dev, args.steps, seed=0, log_every=args.log_every,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, pods=1 if mesh else pods,
                         return_state=pods == 1 and mesh is None, mesh=mesh)
    if pods > 1 and records:
        what = "pods' blocks" if mesh is not None else "replicas"
        print(f"[pods] {pods} {what} bit for bit the same after every step; step {records[-1]['step']} "
              f"digest {records[-1]['digests'][0]}")
    return state


if __name__ == "__main__":
    main()
