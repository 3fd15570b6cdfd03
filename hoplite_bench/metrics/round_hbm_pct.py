"""The whole round's share of the card's HBM bandwidth: the least bytes of a
round, over the bandwidth, divided by the traced window's time per round.

Per gradient reduced (``take`` a round): its shard X read once
(samples * dim * 4), w read once and the gradient written once (2 * dim * 4).
Then the take-way reduce ((take + 1) * dim * 4), and the update's two reads
and one write (3 * dim * 4)."""


def least_bytes(dim: int, samples: int, take: int) -> int:
    d = 4 * dim
    return take * (samples * d + 2 * d) + (take + 1) * d + 3 * d


def read(r):
    t, w = r.trace, r.window
    if t is None or r.hbm_bytes_per_s is None or not w.completed:
        return None
    c = r.cell.config
    need = least_bytes(c["dim"], c["samples"], c["take"])
    return 100.0 * need * w.completed / r.hbm_bytes_per_s / t.window_s
