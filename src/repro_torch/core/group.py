"""Rank processes and their point-to-point exchange: the port's counterpart of
``shard_map`` over a named mesh axis (``repro.launch.mesh``) and of
``lax.ppermute`` / ``lax.psum`` inside it.

``run_ranks`` starts n processes that join one process group and all hold
their tensors on the same device, by default the card: the n ranks share one
GPU (NCCL will not put two ranks on one card; CUDA processes can share it).
Gloo carries the bytes between the processes through host buffers.  The
staging is the transport, not a fallback: the tensors, and the hop kernel that
accumulates what arrives, stay on the card.

A rank's place in a collective is ``dist.get_rank(group)`` in the process
group the caller passes (``None`` is the world), as ``lax.axis_index`` is
its place on a mesh axis, and ``dist.get_world_size(group)`` is
``lax.psum(1, axis)``.

A DTensor program on a mesh of such ranks issues all-gathers,
reduce-scatters, all-reduces and all-to-alls of CUDA tensors, which gloo
does not take (it takes ``broadcast`` and ``all_reduce`` only) and NCCL
will not run with two ranks on one card.  The
``staged`` backend (``StagedGroup``) carries them: each collective copies
its blocks into reused host buffers (pinned for the card's tensors), runs
gloo's own collective on them and copies the result back.  It stages CPU
tensors the same way, so that the CPU tests run the path the card runs, and
it gives gloo's bits on either device.  CUDA IPC between the ranks, which
would skip the host, is later work.
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
from torch._C._distributed_c10d import (AllgatherOptions, AllreduceCoalescedOptions, AllreduceOptions,
                                       AllToAllOptions, BarrierOptions, BroadcastOptions, ReduceScatterOptions)

from repro_torch.device import resolve_device

# Seconds a gloo operation (rendezvous, send, receive, all_reduce) may wait
# before it raises.
PG_TIMEOUT_S = 60.0

# Seconds run_ranks waits, after the last result, for the processes to exit.
_EXIT_GRACE_S = 30.0

# The name ``StagedGroup`` is registered under, with ``dist.Backend.register_backend``.
STAGED_BACKEND = "staged"

# The device run_ranks gave this process (``rank_device``); None outside its ranks.
_RANK_DEVICE: List[Optional[torch.device]] = [None]


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


# What this process's staged collectives moved since the last reset, per kind:
# calls, the bytes handed to gloo (this rank's input) and the wall seconds of
# the calls, staging included (``collective_counts``, ``reset_collective_counts``).
_COLLECTIVES: Dict[str, Dict[str, float]] = {}


def collective_counts() -> Dict[str, Dict[str, float]]:
    """Calls, bytes and seconds of this process's ``StagedGroup`` collectives
    since the last reset, per kind."""
    return {k: dict(v) for k, v in _COLLECTIVES.items()}


def reset_collective_counts() -> None:
    _COLLECTIVES.clear()


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _done(result) -> "dist.Work":
    """A finished ``Work`` whose result is ``result``."""
    from torch._C._distributed_c10d import _create_work_from_future
    from torch.futures import Future

    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


class StagedGroup(dist.ProcessGroup):
    """A process group whose collectives go through host buffers and gloo.

    torch makes a process group of a Python class stand for the whole group,
    whatever the device, so this one takes host tensors too: it hands their
    ``send`` and ``recv`` to its gloo group as they are (``exchange`` stages
    the card's bytes itself), and stages every collective's blocks, host or
    card, through its own reused buffers.  Each collective is finished when
    the call returns; the ``Work`` it returns is done.  An operation it does
    not list raises ``NotImplementedError``."""

    def __init__(self, store, rank: int, size: int, timeout: datetime.timedelta):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(dist.PrefixStore(STAGED_BACKEND, store), rank, size, timeout)
        self._staging = Staging()

    def getBackendName(self) -> str:
        return STAGED_BACKEND

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    # -- staging ---------------------------------------------------------------

    def _host(self, role: str, like: torch.Tensor) -> torch.Tensor:
        """A host buffer shaped and typed like ``like``, pinned for the card's."""
        buf = self._staging.buffer(role, like.numel() * like.element_size(), like.device.type == "cuda")
        return buf.view(like.dtype).view(like.shape)

    def _staged_in(self, role: str, t: torch.Tensor) -> torch.Tensor:
        host = self._host(role, t)
        host.copy_(t)  # synchronous from the card: the bytes are on the host before gloo reads them
        return host

    def _run(self, kind: str, ins, outs, call: Callable, in_place: bool = False) -> "dist.Work":
        """Stage ``ins`` (and buffers for ``outs``, or, ``in_place``, the
        staged ins), ``call(host ins, host outs)`` on gloo and wait for it,
        copy the host outs back."""
        t0 = time.perf_counter()
        hin = [self._staged_in(f"in{i}", t) for i, t in enumerate(ins)]
        hout = hin if in_place else [self._host(f"out{i}", t) for i, t in enumerate(outs)]
        call(hin, hout).wait()
        for t, h in zip(outs, hout):
            t.copy_(h)
        rec = _COLLECTIVES.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
        rec["calls"] += 1
        rec["bytes"] += _nbytes(ins)
        rec["seconds"] += time.perf_counter() - t0
        return _done(list(outs))

    def _in_place(self, kind: str, tensors, call: Callable) -> "dist.Work":
        """A collective that writes its inputs (all-reduce, broadcast)."""
        return self._run(kind, tensors, tensors, lambda hin, hout: call(hin), in_place=True)

    # -- the collectives a DTensor program issues -------------------------------

    def allreduce(self, tensors, opts=AllreduceOptions()):
        return self._in_place("all_reduce", tensors, lambda h: self._gloo.allreduce(h, opts))

    def allreduce_coalesced(self, tensors, opts=AllreduceCoalescedOptions()):
        return self._in_place("all_reduce", tensors, lambda h: self._gloo.allreduce_coalesced(h, opts))

    def broadcast(self, tensors, opts=BroadcastOptions()):
        return self._in_place("broadcast", tensors, lambda h: self._gloo.broadcast(h, opts))

    def _allgather_base(self, out, inp, opts=AllgatherOptions()):
        return self._run("all_gather", [inp], [out], lambda i, o: self._gloo._allgather_base(o[0], i[0], opts))

    def allgather_into_tensor_coalesced(self, outs, inps, opts=AllgatherOptions()):
        for out, inp in zip(outs, inps):
            self._allgather_base(out, inp, opts)
        return _done(list(outs))

    def allgather(self, out_lists, inps, opts=AllgatherOptions()):
        (outs,), (inp,) = out_lists, inps
        return self._run("all_gather", [inp], outs,
                         lambda i, o: self._gloo.allgather([o], i, opts))

    def _reduce_scatter_base(self, out, inp, opts=ReduceScatterOptions()):
        return self._run("reduce_scatter", [inp], [out],
                         lambda i, o: self._gloo._reduce_scatter_base(o[0], i[0], opts))

    def reduce_scatter_tensor_coalesced(self, outs, inps, opts=ReduceScatterOptions()):
        for out, inp in zip(outs, inps):
            self._reduce_scatter_base(out, inp, opts)
        return _done(list(outs))

    def alltoall_base(self, out, inp, out_splits, in_splits, opts=AllToAllOptions()):
        return self._run("all_to_all", [inp], [out],
                         lambda i, o: self._gloo.alltoall_base(o[0], i[0], out_splits, in_splits, opts))

    def barrier(self, opts=BarrierOptions()):
        return self._gloo.barrier(opts)

    # the names torch's Python process groups also go by (its bindings call one or the other)
    all_gather_single = _allgather_base
    all_gather_single_coalesced = allgather_into_tensor_coalesced
    reduce_scatter_single = _reduce_scatter_base
    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced
    all_to_all_single = alltoall_base

    # -- point to point: host tensors as they are, the card's staged -------------

    def send(self, tensors, dst: int, tag: int = 0):
        if all(t.device.type == "cpu" for t in tensors):
            return self._gloo.send(tensors, dst, tag)
        return self._run("send", tensors, [], lambda hin, _: self._gloo.send(hin, dst, tag))

    def recv(self, tensors, src: int, tag: int = 0):
        if all(t.device.type == "cpu" for t in tensors):
            return self._gloo.recv(tensors, src, tag)
        return self._run("recv", [], tensors, lambda _, hout: self._gloo.recv(hout, src, tag))


def _lacks(name: str):
    def refuse(self, *args, **kwargs):
        raise NotImplementedError(f"the {STAGED_BACKEND} process group has no {name}")

    refuse.__name__ = name
    return refuse


for _name in ("gather", "scatter", "reduce", "alltoall", "reduce_scatter", "recv_anysource",
              "allgather_coalesced"):
    setattr(StagedGroup, _name, _lacks(_name))


def _create_staged(store, rank: int, size: int, timeout: datetime.timedelta) -> StagedGroup:
    return StagedGroup(store, rank, size, timeout)


def register_staged() -> None:
    """Register ``StagedGroup`` as the backend ``staged`` in this process
    (once), for host and card tensors."""
    if STAGED_BACKEND.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(STAGED_BACKEND, _create_staged, devices=["cpu", "cuda"])


def rank_device() -> Optional[torch.device]:
    """The device ``run_ranks`` gave this rank process; ``None`` elsewhere."""
    return _RANK_DEVICE[0]


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
        _RANK_DEVICE[0] = dev
        register_staged()
        dist.init_process_group(STAGED_BACKEND, init_method=init_method, rank=r, world_size=n,
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
    """Run ``fn(device, *args)`` in ``n`` new processes joined in one
    ``StagedGroup`` (gloo's collectives through host buffers, on either
    device; point to point of host tensors handed to gloo as they are).

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
