"""Rank processes and their point-to-point exchange: the port's counterpart of
``shard_map`` over a named mesh axis (``repro.launch.mesh``) and of
``lax.ppermute`` / ``lax.psum`` inside it.

``run_ranks`` starts n processes that join one gloo process group and all
hold their tensors on the same device, by default the card: the n ranks share
one GPU (NCCL will not put two ranks on one card; CUDA processes can share
it).  Gloo carries the bytes between the processes through host buffers.  The
staging is the transport, not a fallback: the tensors, and the hop kernel that
accumulates what arrives, stay on the card.

A rank's place in a collective is ``dist.get_rank(group)`` in the process
group the caller passes (``None`` is the world), as ``lax.axis_index`` is
its place on a mesh axis, and ``dist.get_world_size(group)`` is
``lax.psum(1, axis)``.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Seconds a gloo operation (rendezvous, send, receive, all_reduce) may wait
# before it raises.
PG_TIMEOUT_S = 60.0

# Seconds run_ranks waits, after the last result, for the processes to exit.
_EXIT_GRACE_S = 30.0


# What this process sent through ``exchange`` since the last reset: bytes and
# sends (``exchange_counts``, ``reset_exchange_counts``).  A trace on torch's
# fake backend, whose sends move nothing, counts the bytes here.
_SENT = {"bytes": 0, "sends": 0}


def exchange_counts() -> Dict[str, int]:
    """Bytes and sends of this process's ``exchange`` calls since the last reset."""
    return dict(_SENT)


def reset_exchange_counts() -> None:
    _SENT.update(bytes=0, sends=0)


def _global(group: Optional[dist.ProcessGroup], r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


class Staging:
    """Host buffers of one call site: allocated at first use, reused by every
    exchange made through it, pinned where the tensors lie on the card."""

    def __init__(self) -> None:
        self._bufs: Dict[str, torch.Tensor] = {}

    def buffer(self, role: str, nbytes: int, pin: bool) -> torch.Tensor:
        buf = self._bufs.get(role)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
            self._bufs[role] = buf
        return buf[:nbytes]


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a contiguous tensor, as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def exchange(send: Optional[torch.Tensor], dst: int, recv_like: Optional[torch.Tensor], src: int,
             group: Optional[dist.ProcessGroup], staging: Staging) -> Optional[torch.Tensor]:
    """One rank's part of a ``ppermute`` step: send ``send`` to group rank
    ``dst`` and receive a tensor like ``recv_like`` from group rank ``src``.

    Either side may be ``None`` (this rank only sends, only receives, or sits
    the step out).  ``staging`` holds the call site's host buffers.  Returns the received tensor on ``recv_like``'s device, or
    ``None``.  Tensors cross as their bytes, so every dtype goes through
    gloo.  Waits are bounded by the process group's timeout.
    """
    if send is None and recv_like is None:
        return None
    works = []
    if recv_like is not None:
        nbytes = recv_like.numel() * recv_like.element_size()
        rbuf = staging.buffer("recv", nbytes, recv_like.device.type == "cuda")
        works.append(dist.irecv(rbuf, src=_global(group, src), group=group))
    if send is not None:
        sbytes = _bytes(send.contiguous())
        sbuf = staging.buffer("send", sbytes.numel(), send.device.type == "cuda")
        sbuf.copy_(sbytes)  # synchronous: the bytes are on the host before gloo reads them
        works.append(dist.isend(sbuf, dst=_global(group, dst), group=group))
        _SENT["bytes"] += sbytes.numel()
        _SENT["sends"] += 1
    for w in works:
        w.wait()
    if recv_like is None:
        return None
    out = torch.empty(recv_like.shape, dtype=recv_like.dtype, device=recv_like.device)
    _bytes(out).copy_(rbuf)
    return out


def psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sum of ``x`` over the group, on every rank: ``dist.all_reduce`` on a
    host copy.  bf16 and f16 are summed in f32 and rounded once at the end."""
    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    host = torch.empty(x.shape, dtype=wide, pin_memory=x.device.type == "cuda")
    host.copy_(x)
    dist.all_reduce(host, group=group)
    return host.to(device=x.device, dtype=x.dtype)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _rank_main(r: int, n: int, init_method: str, device: str, fn: Callable, args: tuple,
               results: "mp.Queue") -> None:
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("gloo", init_method=init_method, rank=r, world_size=n,
                                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out = fn(dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        # pickled here, in-band: the queue's own pickler would pass tensors as
        # shared-memory handles, which die with this process
        results.put((r, True, pickle.dumps(_to_cpu(out))))
    except Exception:  # reported to the parent, which fails the whole run
        results.put((r, False, traceback.format_exc()))


def run_ranks(fn: Callable, n: int, device=None, *args, timeout: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` in ``n`` new processes joined in one gloo group.

    Every rank uses the same ``device``: the card unless ``"cpu"`` is asked for
    (``resolve_device``; with no device and no CUDA this raises before any
    process starts).  Processes are started with ``spawn``; ``fn`` and
    ``args`` must pickle, and ``fn``'s result is moved to the CPU and pickled
    back.  The rendezvous is a file in a new temporary directory, so runs in
    parallel never collide.  Returns the results in rank order.  Raises if any
    rank fails, exits without a result, or the ``timeout`` (seconds, wall
    clock) runs out; it never carries on with fewer ranks.  Every process is
    gone when it returns or raises.
    """
    dev = resolve_device(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, init, str(dev), fn, args, results))
                 for r in range(n)]
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {n - len(got)} of {n} ranks gave no result within {timeout} s")
                try:
                    r, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if i not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank(s) exited without a result (rank, exit code): {dead}")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {r} of {n} failed:\n{payload}")
                got[r] = pickle.loads(payload)
            for p in procs:
                p.join(timeout=max(1.0, min(_EXIT_GRACE_S, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                if p.pid is not None:
                    p.join()
            results.close()
    return [got[r] for r in range(n)]
