"""Atomic, async, elastic checkpoints of a tree of tensors (port of
``repro.checkpoint.checkpoint``).

Layout, file for file and byte for byte the JAX package's (one directory per
step, renamed into place when it is complete):

    ckpt_dir/
      step_00000123/
        MANIFEST.json     # {"step", "leaves": {path: {"file", "shape", "dtype"}}}
        <leafpath>.npy    # one file per leaf, the "/" of its path written "__"

A leaf's path joins the dict keys and list indices above it with "/", and
the leaves are listed in JAX's flatten order, which visits a dict's keys
sorted.  (``repro_torch.tree`` visits them in insertion order, which the
collectives rely on, so this module walks trees itself.)  numpy has no
bfloat16: the JAX package saves ml_dtypes' bfloat16 arrays, whose ``.npy``
header says ``'<V2'`` and whose manifest entry says ``"bfloat16"``.  The
port writes the same header over the leaf's bits, and reads a leaf whose
manifest says ``bfloat16`` back as ``torch.bfloat16`` bit for bit, whatever
its header says.

  * ATOMIC -- a step is written into ``.tmp-step_N-<8 hex>``, each file and
    then the directory fsynced, renamed to ``step_N``, and the parent
    directory fsynced: a crash mid-write leaves the latest complete step as
    it was, and ``list_steps`` never lists a temporary.  (The JAX package's
    docstring promises the fsync; its code makes none.)
  * ASYNC -- ``save_async`` copies every leaf to host memory before it
    returns (the train step updates the parameters and moments in place, so
    the copy must be complete before the next step runs), then writes on a
    thread; ``in_flight`` says whether it still runs, and ``wait`` joins it
    and raises what it raised.
  * ELASTIC -- ``restore`` places each leaf on the device it is given: a
    checkpoint written from the card restores onto the CPU and the other way
    round, and ``tree_like`` may lie on ``meta``
    (``train.step.abstract_state``).  Given ``placements`` (a tree of
    ``placement.Sharding``, the counterpart of the JAX package's
    ``shardings``), each rank reads only its block of each file, in place,
    onto whatever mesh the shardings name; no rank holds a whole leaf.
  * PLACED -- a tree of DTensors (a state on a mesh) is saved by every rank
    of the mesh together: rank 0 gathers it leaf by leaf
    (``placement.gather_to_root``) and alone writes, the same files as one
    process's.
  * SELF-DESCRIBING -- the manifest holds every leaf's shape and type;
    ``restore`` holds them to ``tree_like``'s and raises on a mismatch.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.sharding import placement

# The .npy header's type of a bfloat16 leaf: what numpy writes for ml_dtypes' bfloat16.
_BF16_DESCR = "<V2"

# A snapshot: (path, host array, the leaf's type name) per leaf, in JAX's order;
# a bfloat16 leaf's array holds its bits as int16.
HostLeaves = List[Tuple[str, np.ndarray, str]]


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def named_leaves(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in JAX's flatten order: a dict's keys sorted, a list's
    items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], _join(path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, _join(path, i))
    else:
        yield path, tree


def _map_named(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` on every leaf, in ``tree``'s own structure and order."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, _join(path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, _join(path, i)) for i, v in enumerate(tree))
    return fn(path, tree)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch type (``torch.float32`` -> ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory, complete when this returns (from the
    card: a synchronous copy into pageable memory); a bfloat16 tensor as its
    bits, int16."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.to("cpu", copy=True).contiguous().numpy()


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``'s bytes, fsynced; a bfloat16 leaf under the JAX package's header."""
    with open(path, "wb") as f:
        if dtype == "bfloat16":
            np.lib.format.write_array_header_1_0(f, {"descr": _BF16_DESCR, "fortran_order": False,
                                                     "shape": arr.shape})
            arr.tofile(f)
        else:
            np.lib.format.write_array(f, arr, allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())


class Checkpointer:
    """Checkpoints in ``directory``, of which the newest ``keep`` are kept.

    ``history`` holds one record per save (step, bytes, ``snapshot_s`` for
    the copy to host memory, ``write_s`` for the files once written, whether
    it was ``async``) and per restore (step, bytes, ``restore_s`` in all and
    ``read_s`` of it reading the files)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.history: List[Dict[str, Any]] = []

    # -- save ------------------------------------------------------------------

    def _snapshot(self, step: int, tree, is_async: bool) -> Tuple[Optional[HostLeaves], Dict[str, Any]]:
        """Every leaf on the host; for a placed tree, on rank 0 (``None`` on
        the others, which send their blocks and write nothing)."""
        t0 = time.perf_counter()
        if not any(isinstance(t, DTensor) for _, t in named_leaves(tree)):
            host = [(name, _to_host(leaf), _dtype_name(leaf.dtype)) for name, leaf in named_leaves(tree)]
        else:
            host = []
            for name, leaf in named_leaves(tree):
                whole = placement.gather_to_root(leaf)
                if whole is not None:
                    host.append((name, _to_host(whole), _dtype_name(leaf.dtype)))
            host = host if dist.get_rank() == 0 else None
        rec = {"step": step, "async": is_async, "bytes": sum(a.nbytes for _, a, _ in host or []),
               "snapshot_s": time.perf_counter() - t0}
        self.history.append(rec)
        return host, rec

    def _timed_write(self, step: int, host: HostLeaves, rec: Dict[str, Any]) -> str:
        t0 = time.perf_counter()
        path = self._write(step, host)
        rec["write_s"] = time.perf_counter() - t0
        return path

    def save(self, step: int, tree) -> Optional[str]:
        """Write ``tree`` as step ``step`` now; returns its directory (``None``
        on a rank other than 0 of a placed tree, which writes nothing)."""
        self.wait()  # serialize with any write in flight
        step = int(step)
        host, rec = self._snapshot(step, tree, is_async=False)
        return None if host is None else self._timed_write(step, host, rec)

    def save_async(self, step: int, tree) -> None:
        """Copy ``tree`` to host memory now; write it on a background thread."""
        self.wait()
        step = int(step)
        host, rec = self._snapshot(step, tree, is_async=True)
        if host is None:
            return

        def run():
            try:
                self._timed_write(step, host, rec)
            except BaseException as e:  # noqa: BLE001 -- raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def in_flight(self) -> bool:
        """Whether a ``save_async`` write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join the write in flight, if any, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: HostLeaves) -> str:
        """Write the snapshot ``host`` as step ``step``, dropping each array
        once its file is written: where the OS keeps written files in memory,
        a write then holds one copy of the state, not two."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        # a unique temporary: two writers of one step (a final save racing a
        # periodic one) never collide
        tmp = os.path.join(self.directory, f".tmp-step_{step:08d}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            manifest: Dict[str, Any] = {"step": step, "leaves": {}}
            while host:
                name, arr, dtype = host.pop(0)
                fn = name.replace("/", "__") + ".npy"
                _save_leaf(os.path.join(tmp, fn), arr, dtype)
                manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape), "dtype": dtype}
                del arr
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            _fsync_path(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(self.directory)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------------

    def list_steps(self) -> List[int]:
        """The complete steps on disk, oldest first (temporaries are not listed)."""
        return sorted(int(d[len("step_"):]) for d in os.listdir(self.directory) if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None, device=None, placements=None) -> Tuple[int, Any]:
        """Step ``step`` (default: the latest) in the structure of
        ``tree_like``, each leaf on ``device`` (the card unless ``"cpu"`` is
        asked for; with ``placements``, their meshes' device).  Every leaf of
        ``tree_like`` must be in the checkpoint with its shape and type; a
        mismatch raises ``ValueError``.  ``placements``: a tree like
        ``tree_like`` of ``placement.Sharding``; each leaf comes back as a
        DTensor of it, every rank reading its own block of the file."""
        dev = resolve_device(device) if placements is None else None
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        t0, nbytes, read_s = time.perf_counter(), 0, 0.0

        def load(name: str, like: torch.Tensor) -> torch.Tensor:
            nonlocal read_s
            entry = manifest["leaves"].get(name)
            if entry is None:
                raise ValueError(f"{name}: no such leaf in {d}")
            want = {"shape": list(like.shape), "dtype": _dtype_name(like.dtype)}
            got = {"shape": entry["shape"], "dtype": entry["dtype"]}
            if got != want:
                raise ValueError(f"{name}: the checkpoint holds {got}, the tree wants {want}")
            path = os.path.join(d, entry["file"])
            t = time.perf_counter()
            # one process reads the whole file; a rank of a mesh maps it and reads its block
            arr = np.load(path) if placements is None else np.load(path, mmap_mode="r")
            read_s += time.perf_counter() - t
            if list(arr.shape) != want["shape"]:
                raise ValueError(f"{name}: {entry['file']} holds shape {arr.shape}, its manifest {want['shape']}")
            if want["dtype"] == "bfloat16":
                if arr.dtype.itemsize != 2:
                    raise ValueError(f"{name}: {entry['file']} holds {arr.dtype}, not 2-byte bfloat16 bits")
            elif arr.dtype.name != want["dtype"]:
                raise ValueError(f"{name}: {entry['file']} holds {arr.dtype}, its manifest {want['dtype']}")

            def tensor(part: np.ndarray) -> torch.Tensor:
                nonlocal nbytes
                nbytes += part.nbytes
                if want["dtype"] == "bfloat16":
                    return torch.from_numpy(part.view(np.int16)).view(torch.bfloat16)
                return torch.from_numpy(part)

            if placements is None:
                return tensor(arr).to(dev)

            def read(block):
                nonlocal read_s
                t = time.perf_counter()
                part = np.array(arr[block])  # the block's bytes, read from the file
                read_s += time.perf_counter() - t
                return tensor(part)

            sh = shardings[name]
            dev_of = torch.device(sh.mesh.device_type)
            return placement.place(like, sh.spec, sh.mesh, lambda block: read(block).to(dev_of), source="block",
                                   on=sh.on)

        shardings = dict(named_leaves(placements)) if placements is not None else {}
        tree = _map_named(load, tree_like)
        self.history.append({"step": step, "bytes": nbytes, "restore_s": time.perf_counter() - t0,
                             "read_s": read_s})
        return step, tree
