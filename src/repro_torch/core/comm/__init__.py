"""Pluggable comm transports for the threaded data plane.

See :mod:`repro_torch.core.comm.core` for the interface contract,
:mod:`repro_torch.core.comm.inproc` for the default direct-buffer backend and
:mod:`repro_torch.core.comm.socket` for the localhost asyncio-socket backend.
"""

from repro_torch.core.comm.core import (  # noqa: F401
    ChunkStream,
    CommBackend,
    CommClosedError,
    DEFAULT_BACKEND,
    ENV_VAR,
    FaultableStream,
    RemoteBufferFailed,
    backoff_delay,
    create_backend,
    register_backend,
    resolve_backend_name,
)

# Importing the implementation modules registers their backends.
from repro_torch.core.comm import inproc as _inproc  # noqa: F401,E402
from repro_torch.core.comm import socket as _socket  # noqa: F401,E402
