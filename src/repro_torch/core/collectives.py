"""Hoplite collectives on rank processes: chunk-pipelined chain schedules
(port of ``repro.core.collectives``).

The JAX package writes each schedule as a ``lax.ppermute`` program inside
``shard_map`` over a named axis.  Here the axis is a process group (``None``
is the world, see ``core.group``), ``lax.axis_index`` is the rank in that
group, and every ``ppermute`` step is one ``group.exchange``.  The schedules,
their step counts and their chunking are the reference's:

  * ``chain_allreduce``: reduce chain into the last rank fused with the
    broadcast chain back, C + 2n - 3 steps of one chunk each (n = 2 is the
    ``pairwise_exchange_allreduce``);
  * ``chain_reduce`` / ``chain_broadcast``: the unfused legs, C + n - 2 steps;
  * ``two_level_allreduce``: the paper's 2-D sqrt(n) chain, four legs;
  * ``binomial_broadcast``, ``ring_reduce_scatter``, ``ring_all_gather``,
    ``rs_ag_allreduce``: baselines and the beyond-paper ring;
  * ``hoplite_psum`` and ``grad_sync``: the dispatch by the paper's n*B*L > S.

Every accumulate of a hop (the reference's ``_add_chunk``, ``cur + val``, and
the ``x + peer`` of the pairwise exchange) is ``ops.chunk_reduce``, written in
place into the chunk of the rank's buffer: the hand-written CUDA kernel when
the buffers lie on the card.  Broadcast legs copy.  Ranks with nothing to send
or receive in a step sit it out, where the reference adds a masked 0, so each
element is summed in the reference's order and the f32 results are the JAX
package's bit for bit, whatever the chunk count.

The link constants are the port's own (``core.planner.HOST_STAGED_LINK``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import group as G
from repro_torch.core import planner
from repro_torch.core.planner import HOST_STAGED_LINK, LinkSpec
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

Group = Optional[dist.ProcessGroup]

# The paper's small-object threshold: below 64 KB an object goes through the
# directory inline, and here a plain psum beats any pipelined schedule.
SMALL_TENSOR_BYTES = 64 * 1024

# Autotuned chunk-count clamp: at least one chunk, at most this many steps per
# leg, and never chunks smaller than MIN_CHUNK_BYTES.
MAX_NUM_CHUNKS = 256
MIN_CHUNK_BYTES = 1024


def autotune_num_chunks(
    axis_size: int,
    nbytes: int,
    link: LinkSpec = HOST_STAGED_LINK,
    step_overhead: float = 0.0,
) -> int:
    """Appendix-A optimal chunk count for a fused chain schedule.

    ``C + 2n - 3`` steps of ``S/C`` bytes, each costing ``L + S/(C*B)``, are
    least at ``C* = sqrt((2n-3) * S / (B * L))``, with L the link latency plus
    ``step_overhead``; clamped to [1, MAX_NUM_CHUNKS] and to chunks of at
    least MIN_CHUNK_BYTES.  The port's link latency is measured through the
    whole exchange, so it carries the software overhead and the default
    ``step_overhead`` is 0.
    """
    n = max(2, axis_size)
    eff_latency = link.latency + step_overhead
    c_opt = math.sqrt((2 * n - 3) * nbytes / (link.bandwidth * eff_latency))
    c = int(max(1.0, c_opt))
    c = min(c, MAX_NUM_CHUNKS, max(1, nbytes // MIN_CHUNK_BYTES))
    return c


def two_level_group_sizes(n: int, group_size: Optional[int] = None) -> Tuple[int, int]:
    """(g, m): groups of size ``g``, ``m`` groups, for the 2-D sqrt(n) chain;
    g grows until it divides n.  The 2-D chain's length is about g + m."""
    g = group_size or max(2, math.isqrt(n))
    while n % g != 0:
        g += 1
    return g, n // g


# ---------------------------------------------------------------------------
# step counts and hops: pure functions of the schedule
# ---------------------------------------------------------------------------


def chain_allreduce_steps(n: int, num_chunks: int) -> int:
    """Steps of the fused chain allreduce over n >= 3 ranks."""
    return num_chunks + 2 * n - 3


def chain_leg_steps(n: int, num_chunks: int) -> int:
    """Steps of one unfused chain leg (reduce or broadcast) over n ranks."""
    return num_chunks + n - 2


def two_level_steps(n: int, num_chunks: int, group_size: Optional[int] = None) -> Tuple[int, int, int, int]:
    """Steps of the 2-D chain's four legs: reduce within the groups, reduce
    across the group roots, broadcast back across the roots, broadcast within."""
    g, m = two_level_group_sizes(n, group_size)
    return (chain_leg_steps(g, num_chunks), chain_leg_steps(m, num_chunks),
            chain_leg_steps(m, num_chunks), chain_leg_steps(g, num_chunks))


def hop_launches(method: str, n: int, rank: int, nbytes: int, config: "CollectiveConfig") -> int:
    """``chunk_reduce`` calls that ``grad_sync(method)`` makes in ``rank`` for one
    leaf of ``nbytes``: one for each chunk the rank accumulates in a reduce leg."""
    if method == "hoplite":
        method = config.choose(n, nbytes)
    if method == "psum" or n == 1:
        return 0
    if method == "chain":
        if n == 2:
            return 1  # the pairwise exchange adds once on both ranks
        return config.chunks_for(n, nbytes) if rank >= 1 else 0
    if method == "chain2d":
        C = config.chunks_for_2d(n, nbytes)
        g, _m = two_level_group_sizes(n)
        pos, grp = rank % g, rank // g
        return C * (pos >= 1) + C * (pos == g - 1 and grp >= 1)
    if method == "rs_ag":
        return n - 1
    raise ValueError(f"unknown grad_sync method {method!r}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _to_chunks(x: torch.Tensor, num_chunks: int):
    """x flattened and zero-padded into a new (num_chunks, chunk_elems) buffer."""
    flat = x.reshape(-1)
    n = flat.numel()
    chunk = -(-n // num_chunks)
    buf = torch.zeros(num_chunks * chunk, dtype=x.dtype, device=x.device)
    buf[:n].copy_(flat)
    return buf.reshape(num_chunks, chunk), n


def _from_chunks(chunks: torch.Tensor, orig_elems: int, shape, dtype) -> torch.Tensor:
    return chunks.reshape(-1)[:orig_elems].reshape(shape).to(dtype)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _chain_leg(buf: torch.Tensor, pos: int, length: int, nxt: int, prev: int,
               group: Group, st: G.Staging, reduce: bool) -> None:
    """One pipelined chain leg, in place, along a chain of ``length`` ranks in
    which this one sits at ``pos``: at step t it sends chunk t - pos to ``nxt``
    and takes chunk t - pos + 1 from ``prev``, adding it (a reduce leg) or
    keeping it (a broadcast leg).  C + length - 2 steps."""
    C = buf.shape[0]
    for t in range(chain_leg_steps(length, C)):
        k_send, k_recv = t - pos, t - pos + 1
        send = buf[k_send] if pos < length - 1 and 0 <= k_send < C else None
        take = pos >= 1 and 0 <= k_recv < C
        got = G.exchange(send, nxt, buf[k_recv] if take else None, prev, group, st)
        if take and reduce:
            ops.chunk_reduce(buf[k_recv], got, out=buf[k_recv])
        elif take:
            buf[k_recv].copy_(got)


# ---------------------------------------------------------------------------
# fused chain allreduce (the paper's reduce->broadcast, streamed)
# ---------------------------------------------------------------------------


def pairwise_exchange_allreduce(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """n == 2 degenerate chain: one bidirectional exchange, then ``x + peer``."""
    x = x.contiguous()
    peer_rank = 1 - dist.get_rank(group)
    peer = G.exchange(x, peer_rank, x, peer_rank, group, G.Staging())
    return ops.chunk_reduce(x, peer)


def chain_allreduce(x: torch.Tensor, group: Group = None, num_chunks: Optional[int] = None) -> torch.Tensor:
    """Hoplite allreduce: pipelined chain reduce into rank n-1, fused with the
    pipelined chain broadcast back toward rank 0.  Chunk k is complete at rank
    n-1 at step k+n-2 and starts down at step k+n-1, while chunks k+1.. are
    still reducing (paper sections 4.2/4.3).  ``num_chunks=None`` autotunes C.
    """
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if n == 2:
        return pairwise_exchange_allreduce(x, group)
    idx = dist.get_rank(group)
    C = num_chunks or autotune_num_chunks(n, _nbytes(x))
    acc, orig = _to_chunks(x, C)  # partial sums (reduce direction)
    fin = torch.zeros_like(acc)  # final values (broadcast direction)
    st = G.Staging()
    for t in range(chain_allreduce_steps(n, C)):
        # reduce leg: i sends acc[t-i] to i+1, which accumulates it
        k_send, k_recv = t - idx, t - idx + 1
        send = acc[k_send] if idx < n - 1 and 0 <= k_send < C else None
        take = idx >= 1 and 0 <= k_recv < C
        got = G.exchange(send, idx + 1, acc[k_recv] if take else None, idx - 1, group, st)
        if take:
            ops.chunk_reduce(acc[k_recv], got, out=acc[k_recv])
        # broadcast leg: i sends final[t - 2(n-1) + i] to i-1
        k_bsend = t - 2 * (n - 1) + idx
        k_brecv = k_bsend + 1
        send = None
        if idx >= 1 and 0 <= k_bsend < C:
            send = (acc if idx == n - 1 else fin)[k_bsend]
        take = idx <= n - 2 and 0 <= k_brecv < C
        got = G.exchange(send, idx - 1, fin[k_brecv] if take else None, idx + 1, group, st)
        if take:
            fin[k_brecv].copy_(got)
    return _from_chunks(acc if idx == n - 1 else fin, orig, x.shape, x.dtype)


# ---------------------------------------------------------------------------
# unfused building blocks
# ---------------------------------------------------------------------------


def chain_reduce(x: torch.Tensor, group: Group = None, num_chunks: Optional[int] = None) -> torch.Tensor:
    """Pipelined 1-D chain reduce into rank n-1 (the others return partials)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    C = num_chunks or autotune_num_chunks(n, _nbytes(x))
    acc, orig = _to_chunks(x, C)
    _chain_leg(acc, idx, n, idx + 1, idx - 1, group, G.Staging(), reduce=True)
    return _from_chunks(acc, orig, x.shape, x.dtype)


def chain_broadcast(x: torch.Tensor, group: Group = None, num_chunks: Optional[int] = None,
                    root: str = "last") -> torch.Tensor:
    """Pipelined chain broadcast from rank n-1 (or 0) through every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    C = num_chunks or autotune_num_chunks(n, _nbytes(x))
    buf, orig = _to_chunks(x, C)
    if root == "last":
        _chain_leg(buf, n - 1 - idx, n, idx - 1, idx + 1, group, G.Staging(), reduce=False)
    else:
        _chain_leg(buf, idx, n, idx + 1, idx - 1, group, G.Staging(), reduce=False)
    return _from_chunks(buf, orig, x.shape, x.dtype)


def binomial_broadcast(x: torch.Tensor, group: Group = None, root: int = 0) -> torch.Tensor:
    """MPI-style static binomial tree broadcast (log2 n rounds, store and
    forward); the baseline of the reference's comparisons."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = dist.get_rank(group)
    vidx = (idx - root) % n  # rotate so root behaves as rank 0
    st = G.Staging()
    for r in range(max(1, math.ceil(math.log2(n)))):
        span = 1 << r
        send = x if vidx < span and vidx + span < n else None
        take = span <= vidx < 2 * span
        got = G.exchange(send, (vidx + span + root) % n, x if take else None,
                         (vidx - span + root) % n, group, st)
        if take:
            x = got
    return x


# ---------------------------------------------------------------------------
# two-level (2-D sqrt-n) chain allreduce
# ---------------------------------------------------------------------------


def two_level_allreduce(x: torch.Tensor, group: Group = None, num_chunks: Optional[int] = None,
                        group_size: Optional[int] = None) -> torch.Tensor:
    """The paper's 2-D chain: sqrt(n) chains of sqrt(n) reduce into each
    group's last rank, a chain over those roots reduces into the last one,
    then two broadcast legs mirror back down both levels."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    g, m = two_level_group_sizes(n, group_size)
    idx = dist.get_rank(group)
    C = num_chunks or autotune_num_chunks(g + m, _nbytes(x))
    buf, orig = _to_chunks(x, C)
    pos, grp = idx % g, idx // g
    st = G.Staging()
    _chain_leg(buf, pos, g, idx + 1, idx - 1, group, st, reduce=True)
    if pos == g - 1:  # the group roots
        _chain_leg(buf, grp, m, idx + g, idx - g, group, st, reduce=True)
        _chain_leg(buf, m - 1 - grp, m, idx - g, idx + g, group, st, reduce=False)
    _chain_leg(buf, g - 1 - pos, g, idx - 1, idx + 1, group, st, reduce=False)
    return _from_chunks(buf, orig, x.shape, x.dtype)


# ---------------------------------------------------------------------------
# beyond-paper: bandwidth-optimal ring forms
# ---------------------------------------------------------------------------


def ring_reduce_scatter(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Ring reduce-scatter: this rank's 1/n sum shard (flattened)."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    shards = torch.zeros(flat.numel() + pad, dtype=x.dtype, device=x.device)
    shards[: flat.numel()].copy_(flat)
    shards = shards.reshape(n, -1)
    if n == 1:
        return shards[0]
    idx = dist.get_rank(group)
    st = G.Staging()
    for t in range(n - 1):
        send_k, recv_k = (idx - t) % n, (idx - t - 1) % n
        got = G.exchange(shards[send_k], (idx + 1) % n, shards[recv_k], (idx - 1) % n, group, st)
        ops.chunk_reduce(shards[recv_k], got, out=shards[recv_k])
    return shards[(idx + 1) % n]


def ring_all_gather(shard: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Ring all-gather of equal shards -> (n, *shard.shape)."""
    n = dist.get_world_size(group)
    if n == 1:
        return shard[None]
    idx = dist.get_rank(group)
    out = torch.zeros((n,) + tuple(shard.shape), dtype=shard.dtype, device=shard.device)
    out[(idx + 1) % n].copy_(shard)
    st = G.Staging()
    for t in range(n - 1):
        send_k, recv_k = (idx + 1 - t) % n, (idx - t) % n
        got = G.exchange(out[send_k], (idx + 1) % n, out[recv_k], (idx - 1) % n, group, st)
        out[recv_k].copy_(got)
    return out


def rs_ag_allreduce(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Reduce-scatter then all-gather (bandwidth-optimal).  The all-gather
    seeds rank i's shard at its logical slot (i+1)%n, so the gathered rows
    are already in chunk order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    gathered = ring_all_gather(ring_reduce_scatter(x, group), group)
    return gathered.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# dispatcher: the nBL > S rule with the port's link
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    """Selection policy for one process group (paper section 4.3 + App. A).

    ``num_chunks=None`` derives the chunk count of each collective from the
    Appendix-A model over (group size, nbytes, link, step_overhead); an
    integer pins it."""

    link: LinkSpec = HOST_STAGED_LINK
    num_chunks: Optional[int] = None
    small_bytes: int = SMALL_TENSOR_BYTES
    # per-step software overhead, seconds; the measured link latency already
    # carries the port's (see autotune_num_chunks)
    step_overhead: float = 0.0

    def effective_latency(self) -> float:
        return self.link.latency + self.step_overhead

    def chunks_for(self, axis_size: int, nbytes: int) -> int:
        """Chunk count for a 1-D chain over ``axis_size`` ranks."""
        if self.num_chunks is not None:
            return self.num_chunks
        return autotune_num_chunks(axis_size, nbytes, self.link, self.step_overhead)

    def chunks_for_2d(self, axis_size: int, nbytes: int) -> int:
        """Chunk count for the 2-D schedule, whose chain length is g + m."""
        if self.num_chunks is not None:
            return self.num_chunks
        g, m = two_level_group_sizes(axis_size)
        return autotune_num_chunks(g + m, nbytes, self.link, self.step_overhead)

    def choose(self, axis_size: int, nbytes: int) -> str:
        if nbytes < self.small_bytes or axis_size <= 2:
            return "psum"
        eff = LinkSpec(self.link.bandwidth, self.effective_latency())
        if planner.use_two_dimensional(axis_size, eff, nbytes):
            return "chain2d"
        return "chain"


# The reference has one config for a TPU pod's ICI and one for the DCN between
# pods.  Here every rank is a process on the card's host and both roles run
# over the one host-staged link, so one config serves both.
HOST_STAGED_CONFIG = CollectiveConfig(link=HOST_STAGED_LINK)


def hoplite_psum(x: torch.Tensor, group: Group = None, config: CollectiveConfig = HOST_STAGED_CONFIG,
                 axis_size: Optional[int] = None) -> torch.Tensor:
    """Hoplite-scheduled allreduce over one group: a small tensor goes to
    psum, else the fused 1-D chain if n*B*L <= S, else the 2-D chain."""
    n = axis_size if axis_size is not None else dist.get_world_size(group)
    nbytes = _nbytes(x)
    method = config.choose(n, nbytes)
    if method == "psum":
        return G.psum(x, group)
    if method == "chain2d":
        return two_level_allreduce(x, group, config.chunks_for_2d(n, nbytes))
    return chain_allreduce(x, group, config.chunks_for(n, nbytes))


def grad_sync(grads, group: Group = None, method: str = "hoplite",
              config: CollectiveConfig = HOST_STAGED_CONFIG, mean: bool = True):
    """Synchronize a gradient tree over ``group``.

    methods: 'psum' (gloo all_reduce), 'hoplite' (paper-faithful dispatch),
    'chain' / 'chain2d' (forced), 'rs_ag' (beyond-paper ring).
    """
    n = dist.get_world_size(group)

    def one(g):
        if method == "psum":
            out = G.psum(g, group)
        elif method == "hoplite":
            out = hoplite_psum(g, group, config)
        elif method == "chain":
            out = chain_allreduce(g, group, config.chunks_for(n, _nbytes(g)))
        elif method == "chain2d":
            out = two_level_allreduce(g, group, config.chunks_for_2d(n, _nbytes(g)))
        elif method == "rs_ag":
            out = rs_ag_allreduce(g, group)
        else:
            raise ValueError(f"unknown grad_sync method {method!r}")
        return out / n if mean else out

    return tree_map(one, grads)


def partial_fold_scale(mask) -> float:
    """Unbiased-mean correction for a bounded-time partial SUM fold: the
    partial sum of the participants (``mask[i]`` True) times ``n / kept``,
    divided by the world size n, is the participants' mean."""
    mask = tuple(bool(m) for m in mask)
    kept = sum(mask)
    if kept == 0:
        raise ValueError("partial_fold_scale: empty participation mask")
    return len(mask) / kept
