"""Hoplite-Serve: fault-tolerant ensemble serving over the task runtime
(port of ``repro.serve``).

Layered on :class:`repro_torch.runtime.Runtime` / ``LocalCluster``, whose
objects are tensors on the card unless the runtime runs on the CPU:

  * :mod:`repro_torch.serve.router`   -- open-loop front-end (Poisson
    arrivals, admission control, per-replica queues);
  * :mod:`repro_torch.serve.ensemble` -- broadcast fan-out, ``wait(k of n)``
    + annotated reduce aggregation, straggler/failure cut-off;
  * :mod:`repro_torch.serve.deploy`   -- versioned weight deployment through
    the receiver-driven broadcast tree, hot-swap mid-traffic;
  * :mod:`repro_torch.serve.metrics`  -- telemetry shared with the simulator;
  * :mod:`repro_torch.serve.autoscaler` -- queue-driven elastic scaling of
    the replica set (join via the broadcast tree, leave via drain_node).
"""

from repro_torch.serve.autoscaler import AutoscalerConfig, QueueAutoscaler
from repro_torch.serve.deploy import WeightDeployment
from repro_torch.serve.ensemble import EnsembleConfig, EnsembleGroup, QuorumLost, ReplicaHandle
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.router import OpenLoopRouter, Rejected, ReplicaQueue, RouterConfig

__all__ = [
    "AutoscalerConfig",
    "EnsembleConfig",
    "EnsembleGroup",
    "LatencyHistogram",
    "OpenLoopRouter",
    "QueueAutoscaler",
    "QuorumLost",
    "Rejected",
    "ReplicaHandle",
    "ReplicaQueue",
    "RouterConfig",
    "ServeMetrics",
    "WeightDeployment",
]
