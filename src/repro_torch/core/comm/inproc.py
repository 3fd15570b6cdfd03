"""In-process comm backend: direct-buffer streaming (the default).

Behavior-identical to the pre-comm plane: a stream is a handle on the
sender's :class:`~repro_torch.core.store.ChunkedBuffer`, ``recv`` blocks on
its watermark condition and returns zero-copy views.  No endpoints, no
relaying -- reduce folds keep reading remote input buffers directly.
Injected connection faults (``ConnFault``) still apply (the cluster
wraps streams in :class:`~repro_torch.core.comm.core.FaultableStream` and
drops/delays connects), so the chaos suites exercise the reconnect and
resume machinery on this backend too.

In the port the windows are tensor views of the sender's buffer on the
cluster's device: still zero-copy, the receiver's ``write_chunk`` is the
one device copy."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.comm.core import (
    ChunkStream,
    CommBackend,
    RemoteBufferFailed,
    register_backend,
)


class InProcStream(ChunkStream):
    """Zero-copy view stream over the sender's own buffer."""

    def __init__(self, src_buf):
        self._buf = src_buf

    def recv(self, pos: int, limit: int, timeout: Optional[float] = None) -> Optional[torch.Tensor]:
        avail = self._buf.wait_for_bytes(pos + 1, timeout=timeout)
        if self._buf.failed:
            raise RemoteBufferFailed(f"buffer failed at {self._buf.bytes_present}")
        if avail <= pos:
            return None
        return self._buf.view(pos, min(avail, pos + limit))

    def abort(self) -> None:
        pass

    def close(self) -> None:
        pass


class InProcBackend(CommBackend):
    name = "inproc"
    relays = False

    def attach(self, cluster) -> None:
        pass

    def open_stream(self, src, dst, object_id, src_buf, start) -> InProcStream:
        return InProcStream(src_buf)


register_backend("inproc", InProcBackend)
