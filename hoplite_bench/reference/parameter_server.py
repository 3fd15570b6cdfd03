"""The plain reference of the parameter-server cells, and their judge.

From the shards and the membership of each round, which the driver records
(the worker of each gradient reduced, and the version of ``w`` it was
computed on), the reference recomputes every version of the parameters:

    w[0] = 0
    w[r + 1] = w[r] + (sum over the round's (worker, v) of
                       X_worker^T (X_worker w[v] - y_worker) / samples) * (-lr / take)

in f32, TF32 off.  Nothing of the program is imported, and nothing the
program made is read but the versions it is judged on.
"""

from __future__ import annotations

import torch

# The controls' precisions, each the step below the configuration's f32
# with TF32 off: TF32 (operands rounded to 10 bits of mantissa, products
# summed in f32) applied to every product of the gradient; and bfloat16 for
# the program's own arithmetic, the SUM of each round's gradients, each
# gradient rounded to it and summed in it.
TF32_DROP_BITS = 13
REDUCE_CONTROL_DTYPE = torch.bfloat16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties away from zero), kept
    in f32."""
    bits = x.contiguous().view(torch.int32)
    half = 1 << (TF32_DROP_BITS - 1)
    return ((bits + half) & ~((1 << TF32_DROP_BITS) - 1)).view(torch.float32)


def gradient(X, y, w, tf32: bool = False):
    if tf32:
        X, w = round_tf32(X), round_tf32(w)
        resid = round_tf32(X @ w - y)
        return X.T @ resid / len(y)
    return X.T @ (X @ w - y) / len(y)


def replay(shards, membership, lr: float, take: int, dim: int, wanted, tf32: bool = False,
           reduce_dtype=torch.float32) -> dict:
    """The versions ``wanted`` of ``w``, recomputed round by round, each
    round's gradients summed in ``reduce_dtype``; a version is dropped once
    no later round and no wanted entry needs it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    device = shards[0][0].device
    last_use = {r: r for r in range(len(membership))}  # the last round that reads each version
    for r, members in enumerate(membership):
        for _, v in members:
            last_use[v] = max(last_use[v], r)
    wanted = set(wanted)
    w = {0: torch.zeros(dim, dtype=torch.float32, device=device)}
    out = {0: w[0]} if 0 in wanted else {}
    for r, members in enumerate(membership):
        g = None
        for worker, v in members:
            X, y = shards[worker]
            gi = gradient(X, y, w[v], tf32).to(reduce_dtype)
            g = gi if g is None else g.add_(gi)
        w[r + 1] = g.float() / take * (-lr) + w[r]
        if r + 1 in wanted:
            out[r + 1] = w[r + 1]
        for v in [v for v in w if last_use.get(v, -1) <= r and v != r + 1]:
            del w[v]
    return out


def judge(shards, membership, lr: float, take: int, dim: int, got: dict, wanted) -> dict:
    """Readings of the program's versions ``got`` (version -> w):

      * ``missing_versions``: versions wanted and not given;
      * ``bad_rounds``: rounds that did not reduce the gradients of ``take``
        distinct workers;
      * ``param_rel_err``: the largest, over the versions compared, of
        ``|w - w_ref| / |w_ref|`` in the L2 norm."""
    bad = sum(1 for m in membership if len({worker for worker, _ in m}) != take)
    ref = replay(shards, membership, lr, take, dim, wanted)
    worst = 0.0
    for v, w_ref in ref.items():
        if v in got:
            norm = float(torch.linalg.vector_norm(w_ref.double()))
            gap = float(torch.linalg.vector_norm(got[v].double() - w_ref.double()))
            worst = max(worst, gap / norm if norm > 0 else gap)
    missing = sum(1 for v in wanted if v not in got)
    return {"missing_versions": missing, "bad_rounds": bad, "param_rel_err": worst}


CONTROLS = {"tf32_products": {"tf32": True}, "bf16_reduce": {"reduce_dtype": REDUCE_CONTROL_DTYPE}}


def controls(shards, membership, lr: float, take: int, dim: int, wanted) -> dict:
    """Each control's readings: the reference in a lower precision
    (``CONTROLS``) put in the program's place, judged as the program is."""
    out = {}
    for name, how in CONTROLS.items():
        got = replay(shards, membership, lr, take, dim, wanted, **how)
        out[name] = judge(shards, membership, lr, take, dim, got, wanted)
        del got
    return out
