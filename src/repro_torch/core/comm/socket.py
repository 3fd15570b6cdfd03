"""Socket comm backend: real bytes over localhost TCP (port of
``repro.core.comm.socket``).

Every cluster member gets an *endpoint* -- an asyncio server on an
ephemeral ``127.0.0.1`` port, all endpoints sharing one module-level
event-loop thread.  A receiver opens a connection to the sender's
endpoint, sends one framed request ``(object_id, start)`` and
half-closes its write side; the sender streams length-prefixed data
frames ``(offset, payload)`` gated on the buffer's watermark, then an
EOF frame (or a FAILED frame when its copy fails mid-stream).  The
frame offsets ARE the watermark protocol, so resume after a reconnect
is just a new request from the receiver's ``bytes_present``.

The CLIENT side is deliberately NOT on the event loop: each receiver
connects and reads frames on a raw blocking socket in its own
streaming thread.  Connects and reads then parallelize across
receivers (syscalls drop the GIL) instead of serializing behind the
loop's frame pumping -- under a 16-receiver broadcast fan-out the
loop-based client added tens of milliseconds to first-byte latency at
every relay level, enough to lose the race that keeps the origin's
served-copies at its out-degree cap.

Robustness layer:

* a heartbeat monitor thread pings every live endpoint each
  ``FaultToleranceConfig.heartbeat_interval_s``; a peer silent past
  ``heartbeat_timeout`` is counted (``stats.heartbeat_misses``),
  traced (``CAT_COMM`` ``heartbeat-miss``) and fed to
  ``cluster.fail_node`` -- silent socket death is detected within the
  configured timeout instead of riding request deadlines.  Pings use
  raw blocking sockets and bypass the fault injector, so an injected
  data-plane partition never masquerades as node death.
* ``silence_node`` kills a node's endpoint and live connections
  WITHOUT telling the cluster -- the chaos hook for silent death.
* a stalled sender emits zero-length keepalive frames while polling
  its producer, so a vanished receiver surfaces as a send error (the
  serve task exits and frees the connection) instead of a leaked task.

On device buffers the bytes are staged through pinned host memory: the
serve side copies each window of the sender's buffer into a pinned buffer
it reuses for the connection and writes it from there; the client side
receives each frame into pinned memory, from which the cluster copies it
into the relay or destination buffer on the device.  Both copies run on
the device's default stream and wait for it, so a window is read only
after the kernel that wrote it.

Known limits (single-process test plane): endpoints live in one
process, so directory/metadata access stays in-memory -- only payload
bytes ride the sockets; ports are localhost-ephemeral; throughput is
bounded by the one shared event loop.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import gc
import socket as _socket
import struct
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.comm.core import (
    ChunkStream,
    CommBackend,
    CommClosedError,
    RemoteBufferFailed,
    register_backend,
)
from repro_torch.core.trace import CAT_COMM

REQ_HDR = "!BHQ"  # op, object-id length, start offset
REQ_SIZE = struct.calcsize(REQ_HDR)
FRAME_HDR = "!BQI"  # frame type, offset, payload length
FRAME_SIZE = struct.calcsize(FRAME_HDR)

OP_GET, OP_HB = 1, 2
F_DATA, F_EOF, F_FAILED, F_HBACK = 0, 1, 2, 3

POLL_S = 0.001  # sender-side watermark poll while the producer is behind
KEEPALIVE_S = 0.25  # zero-length frame cadence while polling (peer-gone probe)
SERVER_FRAME_CAP = 1 << 18  # max payload bytes per data frame
CONNECT_TIMEOUT_S = 5.0

# -- shared event-loop thread ------------------------------------------------

_loop_lock = threading.Lock()
_shared_loop: Optional[asyncio.AbstractEventLoop] = None


def _get_loop() -> asyncio.AbstractEventLoop:
    global _shared_loop
    with _loop_lock:
        if _shared_loop is None or _shared_loop.is_closed():
            loop = asyncio.new_event_loop()
            threading.Thread(
                target=loop.run_forever, name="repro-comm-io", daemon=True
            ).start()
            _shared_loop = loop
        return _shared_loop


class SocketChunkStream(ChunkStream):
    """Receiver side of one transfer: a raw blocking socket read in the
    cluster's streaming thread.  ``recv`` reads whole frames (resuming a
    frame left half-read by a timeout) and reassembles them into
    contiguous windows.  Single-threaded by contract: only the owning
    streaming thread calls ``recv``/``abort``/``close``."""

    def __init__(self, sock, start, pin: bool = False):
        self._sock = sock
        self._pin = pin  # receive frames into pinned host memory (device buffers)
        self._pending: deque = deque()  # completed payloads, in offset order
        self._pending_bytes = 0
        self._next = start  # next wire offset expected
        self._state = "open"  # open | eof | failed | closed
        # Partial-frame state carried across recv timeouts: a timeout
        # mid-frame must NOT desync the byte stream.
        self._hdr = bytearray()
        self._frame_len = 0  # payload bytes outstanding for current frame
        self._buf: Optional[torch.Tensor] = None
        self._view: Optional[memoryview] = None
        self._got = 0

    def recv(self, pos: int, limit: int, timeout: Optional[float] = None) -> Optional[torch.Tensor]:
        if self._state == "closed":
            raise CommClosedError("connection lost")
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._pending_bytes == 0:
            if self._state == "eof":
                return None
            if self._state == "failed":
                raise RemoteBufferFailed("sender's copy failed mid-stream")
            if not self._advance(deadline):
                return None  # timed out; partial frame state is kept
        assert pos == self._next - self._pending_bytes, "stream cursor desync"
        take = min(limit, self._pending_bytes)
        parts, got = [], 0
        while got < take:
            chunk = self._pending.popleft()
            need = take - got
            if chunk.numel() > need:
                self._pending.appendleft(chunk[need:])
                chunk = chunk[:need]
            parts.append(chunk)
            got += chunk.numel()
        self._pending_bytes -= take
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _advance(self, deadline) -> bool:
        """Make progress on the wire: complete (at most) one frame.
        Returns False on timeout; raises CommClosedError on a lost
        connection or protocol desync; keepalives count as progress."""
        if self._buf is None:
            if not self._fill_header(deadline):
                return False
            ftype, off, length = struct.unpack(FRAME_HDR, bytes(self._hdr))
            self._hdr.clear()
            if ftype == F_EOF:
                self._state = "eof"
                return True
            if ftype == F_FAILED:
                self._state = "failed"
                return True
            if length == 0:
                return True  # sender keepalive while its producer stalls
            if off != self._next:
                self._state = "closed"
                raise CommClosedError(
                    f"frame offset desync: got {off}, expected {self._next}"
                )
            self._buf = torch.empty(length, dtype=torch.uint8, pin_memory=self._pin)
            self._view = memoryview(self._buf.numpy())
            self._frame_len = length
            self._got = 0
        view = self._view
        while self._got < self._frame_len:
            n = self._recv_into(view[self._got:], deadline)
            if n is None:
                return False
            self._got += n
        self._pending.append(self._buf)
        self._pending_bytes += self._frame_len
        self._next += self._frame_len
        self._buf = None
        self._view = None
        return True

    def _fill_header(self, deadline) -> bool:
        while len(self._hdr) < FRAME_SIZE:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            part = self._recv_bytes(FRAME_SIZE - len(self._hdr), remaining)
            if part is None:
                return False
            self._hdr += part
        return True

    def _recv_bytes(self, want: int, remaining) -> Optional[bytes]:
        try:
            self._sock.settimeout(remaining)
            part = self._sock.recv(want)
        except TimeoutError:
            return None
        except OSError as e:
            self._state = "closed"
            raise CommClosedError(f"connection lost: {e}") from e
        if not part:
            self._state = "closed"
            raise CommClosedError("connection closed by sender")
        return part

    def _recv_into(self, view, deadline) -> Optional[int]:
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            return None
        try:
            self._sock.settimeout(remaining)
            n = self._sock.recv_into(view)
        except TimeoutError:
            return None
        except OSError as e:
            self._state = "closed"
            raise CommClosedError(f"connection lost: {e}") from e
        if n == 0:
            self._state = "closed"
            raise CommClosedError("connection closed by sender")
        return n

    def abort(self) -> None:
        # RST, not FIN: the sender's next drain errors immediately (the
        # transport.abort shape), freeing its outbound connection.
        with contextlib.suppress(OSError):
            self._sock.setsockopt(
                _socket.SOL_SOCKET, _socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
        with contextlib.suppress(OSError):
            self._sock.close()
        self._state = "closed"

    def close(self) -> None:
        with contextlib.suppress(OSError):
            self._sock.close()


class SocketBackend(CommBackend):
    name = "socket"
    relays = True

    def __init__(self):
        self._cluster = lambda: None  # weakref, set by attach
        self._servers: Dict[int, asyncio.AbstractServer] = {}
        self._addr: Dict[int, Tuple[str, int]] = {}
        self._conns: Dict[int, set] = {}
        self._silenced: set = set()
        self._last_ok: Dict[int, float] = {}
        self._detected: set = set()  # nodes already failed by heartbeat
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------

    def attach(self, cluster) -> None:
        # Reap abandoned clusters BEFORE adding load to the shared IO
        # loop: a LocalCluster is cyclic (directory callbacks, injector
        # back-refs), so dropped instances wait on the generational GC --
        # meanwhile their endpoints and heartbeat threads keep competing
        # for the loop and skew a fresh cluster's relay timing.  Cluster
        # construction is the natural (and cheap) collection point.
        gc.collect()
        self._cluster = weakref.ref(cluster)
        for node in list(cluster.stores.ids()):
            self._start_endpoint(node)
        # Dropped clusters must not leak listeners/threads: stop() runs
        # when the cluster is collected even without an explicit
        # shutdown() (the finalizer holds the backend, not the cluster).
        weakref.finalize(cluster, self.stop)
        if cluster.ft.heartbeat_timeout > 0:
            self._hb_thread = threading.Thread(
                target=_hb_loop,
                args=(weakref.ref(self), self._stop_evt),
                name="repro-comm-hb",
                daemon=True,
            )
            self._hb_thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            nodes = list(self._servers)
        for node in nodes:
            self._close_endpoint(node)

    # -- endpoints ----------------------------------------------------------

    def _start_endpoint(self, node: int) -> None:
        loop = _get_loop()

        async def _go():
            return await asyncio.start_server(
                functools.partial(self._serve_conn, node), "127.0.0.1", 0
            )

        server = asyncio.run_coroutine_threadsafe(_go(), loop).result(CONNECT_TIMEOUT_S)
        port = server.sockets[0].getsockname()[1]
        with self._lock:
            self._servers[node] = server
            self._addr[node] = ("127.0.0.1", port)
            self._conns.setdefault(node, set())
            self._last_ok[node] = time.monotonic()
            self._silenced.discard(node)
            self._detected.discard(node)

    def _close_endpoint(self, node: int) -> None:
        with self._lock:
            server = self._servers.pop(node, None)
            self._addr.pop(node, None)
            writers = self._conns.pop(node, set())
            self._last_ok.pop(node, None)
        if server is None and not writers:
            return
        loop = _get_loop()

        def _close():
            if server is not None:
                server.close()
            for w in writers:
                with contextlib.suppress(Exception):
                    w.transport.abort()

        with contextlib.suppress(RuntimeError):
            loop.call_soon_threadsafe(_close)

    def on_node_up(self, node: int) -> None:
        if node not in self._servers:
            self._start_endpoint(node)
        else:
            with self._lock:
                self._last_ok[node] = time.monotonic()
                self._detected.discard(node)

    def on_node_down(self, node: int) -> None:
        self._close_endpoint(node)

    def silence_node(self, node: int) -> None:
        """Chaos hook: kill the node's endpoint and live connections
        WITHOUT marking it dead -- the cluster keeps planning onto it
        until the heartbeat monitor detects the silence.  The stale
        address stays registered, so connects get refused (the silent-
        death shape) rather than failing fast as 'no endpoint'."""
        with self._lock:
            server = self._servers.pop(node, None)
            writers = self._conns.pop(node, set())
            self._silenced.add(node)
            # keep self._addr[node]: connects must be refused, not skipped
        loop = _get_loop()

        def _close():
            if server is not None:
                server.close()
            for w in writers:
                with contextlib.suppress(Exception):
                    w.transport.abort()

        with contextlib.suppress(RuntimeError):
            loop.call_soon_threadsafe(_close)

    # -- server side ---------------------------------------------------------

    async def _serve_conn(self, node, reader, writer):
        with self._lock:
            conns = self._conns.get(node)
            if conns is None or node in self._silenced:
                writer.transport.abort()
                return
            conns.add(writer)
        try:
            hdr = await reader.readexactly(REQ_SIZE)
            op, id_len, start = struct.unpack(REQ_HDR, hdr)
            if op == OP_HB:
                writer.write(struct.pack(FRAME_HDR, F_HBACK, 0, 0))
                await writer.drain()
                return
            object_id = (await reader.readexactly(id_len)).decode("utf-8")
            await self._stream_object(node, object_id, start, writer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # receiver went away: release the connection, keep serving
        finally:
            with self._lock:
                conns = self._conns.get(node)
                if conns is not None:
                    conns.discard(writer)
            with contextlib.suppress(Exception):
                writer.close()

    async def _stream_object(self, node, object_id, start, writer):
        cluster = self._cluster()
        if cluster is None:
            return
        store = cluster.stores.get(node)
        buf = store.get(object_id) if store is not None else None
        if buf is None:
            writer.write(struct.pack(FRAME_HDR, F_FAILED, 0, 0))
            await writer.drain()
            return
        total = buf.size
        cap = max(buf.chunk_size, SERVER_FRAME_CAP)
        pos = start
        last_write = time.monotonic()
        staging = None  # pinned host buffer of the connection (device buffers)
        while pos < total:
            if buf.failed or node in cluster.dead:
                writer.write(struct.pack(FRAME_HDR, F_FAILED, pos, 0))
                await writer.drain()
                return
            avail = buf.bytes_present  # racy read: monotonic watermark
            if avail <= pos:
                if writer.is_closing():
                    return
                if time.monotonic() - last_write >= KEEPALIVE_S:
                    # Zero-length keepalive: a vanished receiver turns the
                    # next drain into an error instead of a leaked poller.
                    writer.write(struct.pack(FRAME_HDR, F_DATA, pos, 0))
                    await writer.drain()
                    last_write = time.monotonic()
                await asyncio.sleep(POLL_S)
                continue
            avail = min(avail, pos + cap)
            # bytes below the watermark are immutable: tobytes() is a
            # consistent snapshot even while the producer appends.
            window = buf.view(pos, avail)
            if window.device.type != "cpu":
                if staging is None:
                    staging = torch.empty(cap, dtype=torch.uint8, pin_memory=True)
                window = staging[: avail - pos].copy_(window)
            writer.write(struct.pack(FRAME_HDR, F_DATA, pos, avail - pos))
            writer.write(window.numpy().tobytes())
            await writer.drain()
            last_write = time.monotonic()
            pos = avail
        writer.write(struct.pack(FRAME_HDR, F_EOF, pos, 0))
        await writer.drain()

    # -- client side ---------------------------------------------------------

    def open_stream(self, src, dst, object_id, src_buf, start) -> SocketChunkStream:
        addr = self._addr.get(src)
        if addr is None:
            raise CommClosedError(f"no endpoint for node {src}")
        payload = object_id.encode("utf-8")
        try:
            sock = _socket.create_connection(addr, timeout=CONNECT_TIMEOUT_S)
        except OSError as e:
            raise CommClosedError(f"connect to node {src} failed: {e}") from e
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            sock.sendall(
                struct.pack(REQ_HDR, OP_GET, len(payload), start) + payload
            )
            sock.shutdown(_socket.SHUT_WR)  # half-close: request channel done
        except OSError as e:
            with contextlib.suppress(OSError):
                sock.close()
            raise CommClosedError(f"request to node {src} failed: {e}") from e
        return SocketChunkStream(sock, start, pin=src_buf.device.type == "cuda")

    # -- heartbeat monitor ----------------------------------------------------

    def _heartbeat_round(self) -> None:
        cluster = self._cluster()
        if cluster is None:
            self.stop()
            return
        interval = cluster.ft.heartbeat_interval_s
        now = time.monotonic()
        with self._lock:
            nodes = list(self._addr)
        for node in nodes:
            if node in cluster.dead or node in self._detected:
                continue
            if self._ping(node, timeout=max(0.05, interval)):
                self._last_ok[node] = now
                continue
            if now - self._last_ok.get(node, now) < cluster.ft.heartbeat_timeout:
                continue
            # Silent past the timeout: count, trace, and feed the failure
            # plane.  The counter and the instant move together (the
            # trace-instants == stats invariant the chaos suite asserts).
            self._detected.add(node)
            cluster._stats.heartbeat_misses += 1
            if cluster.trace.enabled:
                cluster.trace.instant(
                    CAT_COMM, "heartbeat-miss", node, "",
                    silent_for=round(now - self._last_ok.get(node, now), 3),
                )
            with contextlib.suppress(Exception):
                cluster.fail_node(node)

    def _ping(self, node: int, timeout: float) -> bool:
        """Blocking heartbeat exchange on a raw socket (independent of
        the event loop, so a wedged loop also reads as silence).  Pings
        bypass the fault injector: injected data-plane partitions must
        not read as node death."""
        addr = self._addr.get(node)
        if addr is None:
            return False
        try:
            with _socket.create_connection(addr, timeout=timeout) as s:
                s.settimeout(timeout)
                s.sendall(struct.pack(REQ_HDR, OP_HB, 0, 0))
                got = b""
                while len(got) < FRAME_SIZE:
                    part = s.recv(FRAME_SIZE - len(got))
                    if not part:
                        return False
                    got += part
                ftype, _off, _len = struct.unpack(FRAME_HDR, got)
                return ftype == F_HBACK
        except OSError:
            return False


def _hb_loop(backend_ref, stop_evt) -> None:
    """Monitor thread body: holds only a weakref to the backend, so a
    dropped cluster (and its backend) can be collected -- the loop then
    exits on its own."""
    while True:
        backend = backend_ref()
        if backend is None or stop_evt.is_set():
            return
        cluster = backend._cluster()
        if cluster is None:
            backend.stop()
            return
        interval = cluster.ft.heartbeat_interval_s
        del cluster
        try:
            backend._heartbeat_round()
        except Exception:  # noqa: BLE001 -- monitoring must not die
            pass
        del backend
        if stop_evt.wait(interval):
            return


register_backend("socket", SocketBackend)
