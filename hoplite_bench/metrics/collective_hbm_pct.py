"""The whole collective's share of the card's HBM bandwidth: the least bytes
of one collective, over the bandwidth, divided by the traced window's time
per collective completed.  It bounds a gain whatever kernels the path runs.

  * allreduce of n objects of S bytes over n nodes: 2 * n * S (each input
    read once, each node's result written once);
  * reduce into one node: (n + 1) * S;
  * broadcast to n - 1 nodes: n * S (the source read once, each copy
    written once)."""


def least_bytes(op: str, nodes: int, nbytes: int) -> int:
    return {"allreduce": 2 * nodes, "reduce": nodes + 1, "broadcast": nodes}[op] * nbytes


def read(r):
    t, w = r.trace, r.window
    if t is None or r.hbm_bytes_per_s is None or not w.completed:
        return None
    need = least_bytes(r.cell.traffic["op"], r.cell.config["nodes"], r.cell.traffic["object_bytes"])
    return 100.0 * need * w.completed / r.hbm_bytes_per_s / t.window_s
