"""Comm abstraction: pluggable framed-stream transports for the data plane.

The threaded cluster's byte movement funnels through three legs
(``_stream_copy``, ``_stream_fold`` feeds, ``_fetch_from``); this package
factors the *transport* of those legs behind one interface -- in the
style of dask.distributed's ``comm/core.py`` + ``comm/inproc.py`` +
``comm/asyncio.py`` -- so the same directory/planner/scheduler code
drives an in-process memcpy plane and a real localhost socket plane.

Vocabulary
----------

*Frame*: one contiguous byte window tagged with its absolute offset in
the object (``(offset, payload)``).  Frames of one stream are emitted in
offset order starting from the requested watermark, so a receiver can
splice them straight into its :class:`~repro_torch.core.store.ChunkedBuffer`
watermark protocol -- the transport-level framing IS the watermark
protocol, which is what makes mid-stream resume trivial: reconnect and
re-request from ``bytes_present``.

*ChunkStream*: the receiver's handle on one object transfer.
``recv(pos, limit, timeout)`` returns the next window at exactly
``pos`` (at most ``limit`` bytes), ``None`` on timeout with no progress,
raises :class:`RemoteBufferFailed` when the sender's copy failed
(mapped by the cluster to ``StaleBuffer``), and
:class:`CommClosedError` when the connection died (mapped to
backoff-reconnect, then ``SourceStalled``/re-plan on exhaustion).

*Half-close*: a stream's request channel closes right after the request
is sent (the receiver never writes again); the data channel closes from
the sender side after the final frame.  Either side going away early is
a ``CommClosedError`` on the other, never a hang.

*Backend*: connect/listen factory bound to one cluster.  ``attach``
creates per-node endpoints (listeners); ``open_stream`` connects a
receiver to a sender's endpoint.  Backends with ``relays = True`` move
real bytes between endpoints, so reduce folds stage remote inputs into
local relay buffers; ``relays = False`` backends hand out direct views
of the sender's buffer (today's zero-copy plane, behavior-identical).

Selection: ``LocalCluster(comm_backend="inproc"|"socket")``, defaulting
to the ``REPRO_COMM`` environment variable, defaulting to ``inproc``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.faults import _unit

DEFAULT_BACKEND = "inproc"
ENV_VAR = "REPRO_COMM"


class CommClosedError(ConnectionError):
    """The underlying connection dropped/reset (endpoint down, peer
    closed mid-stream, injected ConnFault).  Recoverable: the cluster
    reconnects with capped exponential backoff and resumes from the
    receiver's watermark."""


class RemoteBufferFailed(RuntimeError):
    """The sender's copy of the object failed (abandoned / node
    restarted) -- the stream can never complete from this source.  The
    cluster maps it to ``StaleBuffer`` (or ``DeadNode``) and re-plans."""


class ChunkStream:
    """One object transfer, receiver side.  Implementations deliver the
    object's bytes from the requested start offset as ordered,
    contiguous windows."""

    def recv(
        self, pos: int, limit: int, timeout: Optional[float] = None
    ) -> Optional[torch.Tensor]:
        """Next window at absolute offset ``pos``: a uint8 tensor of
        1..``limit`` bytes, or ``None`` if no progress within
        ``timeout``.  Raises :class:`RemoteBufferFailed` /
        :class:`CommClosedError` (see module docstring)."""
        raise NotImplementedError

    def abort(self) -> None:
        """Tear the connection down ungracefully (fault injection: a
        mid-stream reset must stop bytes on the wire, not just raise)."""
        self.close()

    def close(self) -> None:
        raise NotImplementedError


class CommBackend:
    """Transport factory bound to one cluster (``attach``).

    Membership hooks (``on_node_up`` / ``on_node_down``) keep per-node
    endpoints in sync with joins/restarts and kills/drains; ``stop``
    releases every listener and connection (idempotent; also registered
    as a weakref finalizer on the cluster so dropped clusters cannot
    leak sockets)."""

    name = "?"
    #: True when the backend moves real bytes between endpoints (reduce
    #: folds must then stage remote inputs into local relay buffers).
    relays = False

    def attach(self, cluster) -> None:
        raise NotImplementedError

    def open_stream(
        self, src: int, dst: int, object_id: str, src_buf, start: int
    ) -> ChunkStream:
        """Connect ``dst`` to ``src``'s endpoint and request ``object_id``
        from absolute offset ``start``.  ``src_buf`` is the sender's
        buffer handle -- relaying backends use it only for metadata
        (size/chunking), never for payload bytes."""
        raise NotImplementedError

    def on_node_up(self, node: int) -> None:  # join / restart
        pass

    def on_node_down(self, node: int) -> None:  # kill / drain departure
        pass

    def stop(self) -> None:
        pass


class FaultableStream(ChunkStream):
    """Wrap any stream with a deterministic injected mid-stream reset:
    the ``reset_at``-th ``recv`` that would deliver bytes instead aborts
    the underlying connection and raises :class:`CommClosedError` --
    the same failure shape a real peer reset produces, byte-positioned
    purely by the fault plan's hash draws."""

    def __init__(self, inner: ChunkStream, reset_at: int, on_trip: Optional[Callable[[], None]] = None):
        self._inner = inner
        self._reset_at = max(1, reset_at)
        self._delivered = 0
        self._on_trip = on_trip

    def recv(self, pos, limit, timeout=None):
        if self._delivered + 1 >= self._reset_at:
            # Peek first: only trip on a recv that would have advanced.
            window = self._inner.recv(pos, limit, timeout)
            if window is None:
                return None
            self._inner.abort()
            if self._on_trip is not None:
                self._on_trip()
            raise CommClosedError("injected connection reset")
        window = self._inner.recv(pos, limit, timeout)
        if window is not None:
            self._delivered += 1
        return window

    def abort(self):
        self._inner.abort()

    def close(self):
        self._inner.close()


def backoff_delay(
    seed: int, src: int, dst: int, attempt: int, base: float, cap: float
) -> float:
    """Capped exponential backoff with deterministic jitter: attempt k
    sleeps ``min(cap, base * 2**k)`` stretched by a jitter factor in
    [0.5, 1.5) drawn from the fault plane's splitmix hash -- pure in
    (seed, src, dst, attempt), so replays back off identically."""
    raw = min(cap, base * (2.0 ** attempt))
    return raw * (0.5 + _unit(seed, 0xB0FF, src, dst, attempt))


# -- backend registry --------------------------------------------------------

_BACKENDS: Dict[str, Callable[[], CommBackend]] = {}


def register_backend(name: str, factory: Callable[[], CommBackend]) -> None:
    _BACKENDS[name] = factory


def resolve_backend_name(name: Optional[str] = None) -> str:
    """Explicit kwarg > ``REPRO_COMM`` env var > ``inproc``."""
    name = name or os.environ.get(ENV_VAR) or DEFAULT_BACKEND
    if name not in _BACKENDS:
        raise ValueError(
            f"unknown comm backend {name!r} (have: {sorted(_BACKENDS)})"
        )
    return name


def create_backend(name: Optional[str] = None) -> CommBackend:
    return _BACKENDS[resolve_backend_name(name)]()
