"""Mini task-based distributed framework (the "Ray" above Hoplite); port of
``repro.runtime``.

Provides dynamic tasks returning futures (paper Figure 1b), executed by a
pool of per-node executors over a LocalCluster object store.  Group
communication (broadcast / reduce) is *not* expressed by the application;
it emerges from Get/Reduce calls exactly as in the paper.
"""

from repro_torch.runtime.runtime import ObjectRef, Runtime, TaskError

__all__ = ["ObjectRef", "Runtime", "TaskError"]
