"""``chunk_reduce``'s share of its roofline: the least bytes the collectives'
reductions need, over the card's HBM bandwidth, divided by the device time of
the ``chunk_reduce`` kernels in the traced window.

A reduce of n objects of S bytes needs at least (n + 1) * S bytes: each
input read once, the result written once.  Any implementation of the same
reduction is held to the same work, however many hops and partials it
folds through."""

KERNEL = "chunk_reduce"


def least_bytes(op: str, nodes: int, nbytes: int) -> int:
    """The least bytes of the reductions in one collective."""
    if op in ("allreduce", "reduce"):
        return (nodes + 1) * nbytes
    return 0


def read(r):
    t, w = r.trace, r.window
    if t is None or r.hbm_bytes_per_s is None or not w.completed:
        return None
    kernel_s = sum(s for name, (s, _) in t.ops.items() if KERNEL in name)
    need = least_bytes(r.cell.traffic["op"], r.cell.config["nodes"], r.cell.traffic["object_bytes"])
    if kernel_s <= 0 or need <= 0:
        return None
    return 100.0 * need * w.completed / r.hbm_bytes_per_s / kernel_s
