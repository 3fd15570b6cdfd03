"""The plain reference of the collective cells, and their judge.

Each client holds ``sets`` input sets of one object a node (one object a set
for ``broadcast``), and each collective takes, at every node, the object of
the set the seed chose for it (its ``choice``).  What a collective must
leave: the sum of the objects it took (``allreduce`` in every node,
``reduce`` in node 0), or the source's bytes (``broadcast``, in every node).
The inputs are drawn again from the seed, in the order the driver drew them
(client, set, node), and summed one at a time in f64; integer values under
2^24 make that sum exact in f32 too.  Plain PyTorch: no module of the program
is imported.
"""

from __future__ import annotations

import torch

from hoplite_bench import inputs

# The control's precision: the reference summed in bfloat16, the nearest
# precision below the configuration's float32 that a fold could be tempted
# into.
CONTROL_DTYPE = torch.bfloat16


def objects_per_set(op: str, nodes: int) -> int:
    return 1 if op == "broadcast" else nodes


def expected(seed: int, device, op: str, clients: int, sets: int, nodes: int, nbytes: int, low: int, high: int,
             wanted, dtype=torch.float64):
    """The expected result, as f32 summed in ``dtype`` (f64 for the
    reference, ``CONTROL_DTYPE`` for the control), of each ``(client,
    choice)`` in ``wanted``, in its order."""
    per = objects_per_set(op, nodes)
    objects = inputs.integer_objects(seed, device, clients * sets * per, nbytes, low, high)
    acc = [None] * len(wanted)
    for client in range(clients):
        for s in range(sets):
            for node in range(per):
                x = next(objects)
                users = [i for i, (c, choice) in enumerate(wanted) if c == client and choice[node] == s]
                if users:
                    x = x.to(dtype)
                for i in users:
                    acc[i] = x.clone() if acc[i] is None else acc[i].add_(x)
                del x
    return [a.to(torch.float32) for a in acc]


def judge(seed: int, device, op: str, clients: int, sets: int, nodes: int, nbytes: int, low: int, high: int,
          outputs, dtype=torch.float64) -> dict:
    """Readings of ``outputs``, a list of (client, choice, {node: uint8
    buffer or None}) of the collectives kept for the check:

      * ``missing_results``: nodes that should hold a result and hold none;
      * ``mismatched_elements``: elements that differ from the reference;
      * ``aliased_buffers``: results that share storage with another
        node's result of the same collective."""
    want = expected(seed, device, op, clients, sets, nodes, nbytes, low, high,
                    [(c, choice) for c, choice, _ in outputs], dtype)
    missing = mismatched = aliased = 0
    for (_, _, bufs), ref in zip(outputs, want):
        ptrs = []
        for buf in bufs.values():
            if buf is None:
                missing += 1
                continue
            got = buf.view(torch.float32)
            mismatched += int((got != ref).sum()) if got.numel() == ref.numel() else ref.numel()
            ptrs.append(buf.untyped_storage().data_ptr())
        aliased += len(ptrs) - len(set(ptrs))
    return {"missing_results": missing, "mismatched_elements": mismatched, "aliased_buffers": aliased}


def controls(seed: int, device, op: str, clients: int, sets: int, nodes: int, nbytes: int, low: int, high: int,
             kept) -> dict:
    """The control's readings: the reference summed in ``CONTROL_DTYPE`` put
    in the program's place, the result of each kept ``(client, choice, result
    nodes)`` in every node that should hold it, judged as the program's are."""
    args = (seed, device, op, clients, sets, nodes, nbytes, low, high)
    got = expected(*args, [(c, choice) for c, choice, _ in kept], CONTROL_DTYPE)
    outputs = [(c, choice, {n: (g if i == 0 else g.clone()).view(torch.uint8) for i, n in enumerate(at)})
               for (c, choice, at), g in zip(kept, got)]
    return {"bf16": judge(*args, outputs)}
