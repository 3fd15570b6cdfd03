"""Cross-pod gradient sync entry point: the train step's Hoplite sync of a
model's gradient tree on n rank processes that share one card.

    PYTHONPATH=src python -m repro_torch.launch.sync --arch qwen3-14b --ranks 4

runs on the card; ``--reduced --device cpu`` runs the small variant on the
CPU.  Each rank draws the gradient tree of one decoder block (the names and
shapes of ``models.transformer.layer_skel``, in the config's
``param_dtype``; four ranks' copies of a whole model's gradients would not
fit one card) from its own seeded generator on its device.  Ranks 0 and 1
first time the exchange itself (what the port's link constant,
``core.planner.HOST_STAGED_LINK``, was measured with), and then all ranks
time it at once around the ring, as the chains load it; then every rank syncs
its tree with each method in turn: ``_pod_sync_fn`` for ``hoplite_chain``,
``hoplite_2d`` and ``hoplite_chain+int8`` (compressed first), and
``grad_sync`` for ``rs_ag`` and ``psum``.  Every rank checks, for each
method, that the result lies on its device, that the hop kernel launched as
often as ``collectives.hop_launches`` predicts, and that the result is the
mean of the n seeded trees, recomputed in f32 on the device, within the
tolerance of the tree's type; ranks must agree bit for bit except after
psum.  Any failure raises.

``--sweep 0.25,0.5,1,2,4`` then times the fused chain (``hoplite_chain``)
again with each leaf's chunk count set to that factor times the autotuned
one, ``--repeats`` rounds of every factor in turn (so a drift of the host
spreads over all factors), and holds every result to the autotuned chain's
bit for bit (per element the sum runs in the same order whatever the chunk
count).
"""

from __future__ import annotations

import argparse
import hashlib
import math
import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import collectives as C
from repro_torch.core import group as G
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.common import tree_map_params
from repro_torch.optim import compression
from repro_torch.train.step import POD_SYNC_METHODS, TrainOptions, _pod_sync_fn
from repro_torch.tree import leaves, tree_map

POD_SYNCS = {
    "hoplite_chain": TrainOptions(pod_sync="hoplite_chain"),
    "hoplite_2d": TrainOptions(pod_sync="hoplite_2d"),
    "hoplite_chain+int8": TrainOptions(pod_sync="hoplite_chain", pod_compression=True),
}
GRAD_SYNCS = ("rs_ag", "psum")
METHODS = tuple(POD_SYNCS) + GRAD_SYNCS

# tests/test_kernels.py:16-17, used as both rtol and atol
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# ping-pong of the link measurement: (bytes, timed round trips)
LINK_SMALL, LINK_LARGE = (1024, 50), (64 << 20, 5)


def grad_tree(cfg, device, seed: int, rank: int):
    """The gradient tree of one decoder block for ``rank``: unit normal values
    drawn from its own generator, in ``cfg.param_dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + rank)
    dtype = getattr(torch, cfg.param_dtype)

    def draw(p):
        return torch.empty(p.shape, dtype=dtype, device=device).normal_(generator=gen)

    return tree_map_params(draw, T.layer_skel(cfg, cfg.pattern[0]))


def method_fn(name: str):
    """(the sync of a gradient tree, the grad_sync method that carries it)."""
    if name in POD_SYNCS:
        opts = POD_SYNCS[name]
        return _pod_sync_fn(opts), POD_SYNC_METHODS[opts.pod_sync]
    if name in GRAD_SYNCS:
        return (lambda g: C.grad_sync(g, None, name, C.HOST_STAGED_CONFIG)), name
    raise ValueError(f"unknown sync method {name!r}; one of {METHODS}")


def _sync_device(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(tree) -> str:
    h = hashlib.sha256()
    for t in leaves(tree):
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def measure_link(dev) -> Optional[Dict[str, float]]:
    """Half the round trip of a ping-pong between ranks 0 and 1 through
    ``group.exchange`` (device tensor to device tensor): the latency from a
    small message, the bandwidth from a large one.  Returned by rank 0."""
    r = dist.get_rank()
    half = {}
    if r < 2:
        st = G.Staging()
        for nbytes, reps in (LINK_SMALL, LINK_LARGE):
            buf = torch.ones(nbytes, dtype=torch.uint8, device=dev)
            times = []
            for _ in range(reps + 1):  # the first round trip warms up
                t0 = time.perf_counter()
                if r == 0:
                    G.exchange(buf, 1, None, 1, None, st)
                    G.exchange(None, 1, buf, 1, None, st)
                else:
                    got = G.exchange(None, 0, buf, 0, None, st)
                    G.exchange(got, 0, None, 0, None, st)
                _sync_device(dev)
                times.append(time.perf_counter() - t0)
            half[nbytes] = statistics.median(times[1:]) / 2
    dist.barrier()
    ring = measure_ring(dev)
    if r != 0:
        return None
    lat = half[LINK_SMALL[0]]
    return {"latency_s": lat, "bandwidth_Bps": LINK_LARGE[0] / (half[LINK_LARGE[0]] - lat),
            "small_bytes": LINK_SMALL[0], "large_bytes": LINK_LARGE[0],
            "large_half_rtt_s": half[LINK_LARGE[0]], "ring": ring}


def measure_ring(dev) -> Dict[str, float]:
    """The link under the chains' load: every rank sends to the next and
    receives from the previous at once, one ``group.exchange`` each, started
    together after a barrier.  The step time is the slowest rank's median;
    latency from the small message, bandwidth from the large one."""
    r, n = dist.get_rank(), dist.get_world_size()
    st = G.Staging()
    step = {}
    for nbytes, reps in (LINK_SMALL, LINK_LARGE):
        buf = torch.ones(nbytes, dtype=torch.uint8, device=dev)
        times = []
        for _ in range(reps + 1):  # the first step warms up
            dist.barrier()
            t0 = time.perf_counter()
            G.exchange(buf, (r + 1) % n, buf, (r - 1) % n, None, st)
            _sync_device(dev)
            times.append(time.perf_counter() - t0)
        slowest = torch.tensor([statistics.median(times[1:])], dtype=torch.float64)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        step[nbytes] = slowest.item()
    lat = step[LINK_SMALL[0]]
    return {"latency_s": lat, "bandwidth_Bps": LINK_LARGE[0] / (step[LINK_LARGE[0]] - lat),
            "large_step_s": step[LINK_LARGE[0]]}


def swept_chunks(sizes: Sequence[int], n: int, factor: float) -> List[int]:
    """Each leaf's chunk count: ``factor`` times the autotuned one, within
    the autotune's clamps."""
    out = []
    for b in sizes:
        c = round(factor * C.HOST_STAGED_CONFIG.chunks_for(n, b))
        out.append(max(1, min(c, C.MAX_NUM_CHUNKS, b // C.MIN_CHUNK_BYTES)))
    return out


def sweep_chunks(dev, grads, digest: str, factors: Sequence[float], repeats: int):
    """Wall times of the fused chain at each factor of the autotuned chunk
    counts, ``repeats`` rounds over the factors; each result must be the
    autotuned chain's (``digest``)."""
    r, n = dist.get_rank(), dist.get_world_size()
    sizes = [t.numel() * t.element_size() for t in leaves(grads)]
    rows = {f: {"chunks": swept_chunks(sizes, n, f), "wall_s": []} for f in factors}
    for _ in range(repeats):
        for f in factors:
            counts = rows[f]["chunks"]
            hops = sum(C.hop_launches("chain", n, r, b, C.CollectiveConfig(num_chunks=c))
                       for b, c in zip(sizes, counts)) if dev.type == "cuda" else 0
            dist.barrier()
            _sync_device(dev)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = [C.chain_allreduce(g, None, c) / n for g, c in zip(leaves(grads), counts)]
            _sync_device(dev)
            rows[f]["wall_s"].append(time.perf_counter() - t0)
            if ops.launch_counts()["chunk_reduce"] != hops:
                raise AssertionError(f"rank {r} sweep x{f}: {ops.launch_counts()['chunk_reduce']} hops, expected {hops}")
            if _digest(out) != digest:
                raise AssertionError(f"rank {r} sweep x{f}: the result is not the autotuned chain's")
            del out
    return rows


def _mean_tree(cfg, dev, seed, n, compressed: bool):
    """The f32 mean of the n ranks' seeded trees (compress-decompressed
    first if asked), recomputed one rank's tree at a time."""
    acc = None
    for q in range(n):
        g = grad_tree(cfg, dev, seed, q)
        if compressed:
            g = tree_map(compression.compress_decompress, g)
        acc = tree_map(lambda t: t.float(), g) if acc is None else tree_map(lambda a, t: a.add_(t.float()), acc, g)
        del g  # before the next rank's tree is drawn: one tree at a time on the card
    return tree_map(lambda a: a.div_(n), acc)


def rank_main(dev, cfg, seed: int, sweep: Sequence[float] = (), repeats: int = 1):
    """One rank's part: time the link, sync the tree by each method and
    check the result, then sweep the fused chain's chunk counts."""
    r, n = dist.get_rank(), dist.get_world_size()
    grads = grad_tree(cfg, dev, seed, r)
    sizes = [t.numel() * t.element_size() for t in leaves(grads)]
    where, dtype = next(leaves(grads)).device, next(leaves(grads)).dtype
    record = {"rank": r, "link": measure_link(dev), "methods": {}}
    want = {}
    for name in METHODS:
        sync, method = method_fn(name)
        hops = sum(C.hop_launches(method, n, r, b, C.HOST_STAGED_CONFIG) for b in sizes)
        expected = dict.fromkeys(ops.launch_counts(), 0)
        expected["chunk_reduce"] = hops if dev.type == "cuda" else 0  # CPU tensors take the plain version
        dist.barrier()
        _sync_device(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = sync(grads)  # the main path
        _sync_device(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != expected:
            raise AssertionError(f"rank {r} {name}: kernel launches {counts}, expected {expected}")
        if any(t.device != where or t.dtype != dtype for t in leaves(out)):
            raise AssertionError(f"rank {r} {name}: a synced leaf left {where} or {dtype}")
        key = name.endswith("+int8")
        if key not in want:
            want[key] = _mean_tree(cfg, dev, seed, n, compressed=key)
        err = 0.0
        for got, ref in zip(leaves(out), leaves(want[key])):
            if got.shape != ref.shape or not torch.isfinite(got).all():
                raise AssertionError(f"rank {r} {name}: a leaf of shape {tuple(got.shape)} is not finite or not {tuple(ref.shape)}")
            err = max(err, (got.float() - ref).abs().max().item())
            if not torch.allclose(got.float(), ref, rtol=TOL[dtype], atol=TOL[dtype]):
                raise AssertionError(f"rank {r} {name}: the sync is not the seeded mean (max abs err {err})")
        record["methods"][name] = {"wall_s": wall, "chunk_reduce": counts["chunk_reduce"],
                                   "max_abs_err": err, "digest": _digest(out)}
        del out
    if sweep:
        record["sweep"] = sweep_chunks(dev, grads, record["methods"]["hoplite_chain"]["digest"], sweep, repeats)
    return record


def run(cfg, ranks: int, device=None, seed: int = 0, timeout: float = 600.0,
        sweep: Sequence[float] = (), repeats: int = 1):
    """Sync on ``ranks`` processes; raise on any failed check.  Returns, per
    method, the slowest rank's wall time, each rank's hop-kernel launches and
    the largest error, and rank 0's link measurement; with ``sweep``, per
    factor the leaves' chunk counts, the slowest rank's wall time in each
    round and their median."""
    recs = G.run_ranks(rank_main, ranks, device, cfg, seed, sweep, repeats, timeout=timeout)
    summary = {"link": recs[0]["link"], "methods": {}}
    for name in METHODS:
        per = [rec["methods"][name] for rec in recs]
        if name != "psum" and len({p["digest"] for p in per}) != 1:
            raise AssertionError(f"{name}: the ranks' results differ")
        summary["methods"][name] = {
            "wall_s": max(p["wall_s"] for p in per), "chunk_reduce": [p["chunk_reduce"] for p in per],
            "max_abs_err": max(p["max_abs_err"] for p in per),
            "ranks_agree": len({p["digest"] for p in per}) == 1}
    for f in sweep:
        rounds = [max(walls) for walls in zip(*(rec["sweep"][f]["wall_s"] for rec in recs))]
        summary.setdefault("sweep", {})[f] = {"chunks": recs[0]["sweep"][f]["chunks"], "rounds_s": rounds,
                                              "wall_s": statistics.median(rounds)}
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: cuda (raises when absent)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", default="", help="factors of the autotuned chunk counts, e.g. 0.25,0.5,1,2,4")
    ap.add_argument("--repeats", type=int, default=3, help="timed runs of each sweep factor")
    args = ap.parse_args(argv)
    sweep = tuple(float(f) for f in args.sweep.split(",") if f)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    dev = resolve_device(args.device)
    elems = sum(math.prod(p.shape) for p in leaves(T.layer_skel(cfg, cfg.pattern[0])))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[sync] {cfg.name}: one block, {elems:,} {cfg.param_dtype} gradients per rank, "
          f"{args.ranks} ranks on {where}")
    summary = run(cfg, args.ranks, dev, args.seed, sweep=sweep, repeats=args.repeats)
    lk, ring = summary["link"], summary["link"]["ring"]
    print(f"[sync] link, ping-pong of ranks 0 and 1: latency {lk['latency_s'] * 1e6:.1f} us, "
          f"bandwidth {lk['bandwidth_Bps'] / 1e9:.3f} GB/s")
    print(f"[sync] link, all {args.ranks} ranks around the ring at once: latency {ring['latency_s'] * 1e6:.1f} us, "
          f"bandwidth {ring['bandwidth_Bps'] / 1e9:.3f} GB/s")
    for name, m in summary["methods"].items():
        print(f"[sync] {name}: {m['wall_s'] * 1e3:.1f} ms, chunk_reduce launches per rank {m['chunk_reduce']}, "
              f"max abs err {m['max_abs_err']:.3e}, ranks agree: {m['ranks_agree']}")
    for f, row in summary.get("sweep", {}).items():
        print(f"[sync] hoplite_chain at {f} x the autotuned chunks {row['chunks']}: "
              f"{row['wall_s'] * 1e3:.1f} ms (median of {args.repeats} rounds, slowest rank; rounds "
              f"{', '.join(f'{t * 1e3:.1f}' for t in row['rounds_s'])} ms)")
    return summary


if __name__ == "__main__":
    main()
