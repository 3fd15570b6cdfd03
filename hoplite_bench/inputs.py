"""The inputs of every cell, drawn from the run's seed on the run's device.

Both sides get the same: the drivers hand these tensors to the program, and
the judge draws them again, in the same order from the same seed, for the
plain reference.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def integer_objects(seed: int, device, count: int, nbytes: int, low: int, high: int):
    """``count`` f32 objects of ``nbytes`` each whose values are integers in
    ``[low, high)``, drawn in order from one generator: every sum of a few
    of them is exact in f32, whatever the order of the folds.  Yields them
    one at a time, so a caller can hold one and drop it."""
    gen = generator(seed, device)
    for _ in range(count):
        yield torch.randint(low, high, (nbytes // 4,), generator=gen, device=device, dtype=torch.float32)


def least_squares_shards(seed: int, device, workers: int, samples: int, dim: int):
    """Shard ``s`` is ``(X, y)``: ``X`` of ``samples x dim`` standard
    normals, ``y = X @ w_true`` with ``w_true`` standard normal, all drawn
    from one generator in the order w_true, X_0, X_1, ..."""
    gen = generator(seed, device)
    w_true = torch.randn(dim, generator=gen, device=device, dtype=torch.float32)
    shards = []
    for _ in range(workers):
        X = torch.randn(samples, dim, generator=gen, device=device, dtype=torch.float32)
        shards.append((X, X @ w_true))
    return shards
