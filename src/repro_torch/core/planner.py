"""Link model and chain planning of the port (port of ``repro.core.planner``).

The planner decides, for a reduce over ``n`` objects of size ``S`` on links
with bandwidth ``B`` (bytes/s) and latency ``L`` (s), whether to use a
one-dimensional pipelined chain or to recursively split into sqrt(n)
chains of sqrt(n) ("two-dimensional chain").  Paper Appendix A:

    T_1d(n) = S/B + (n-1) L
    T_2d(n) = 2 T_1d(sqrt(n)) = 2S/B + 2(sqrt(n)-1) L

    use 1-D  when  n B L <= S
    use 2-D  when  n B L  > S

and each sqrt(n) chain recursively breaks down until m B L <= S, giving
O(log log n) recursion depth.

Two links are defined here.  ``EC2_LINK`` is the paper's testbed and the
data plane's default (``core.local.LocalCluster``).  ``HOST_STAGED_LINK``
is the port's own, measured on the card's machine: the exchange of
``core.group.exchange`` between two rank processes that share the card,
staged through host buffers and carried by gloo over the host; the
collectives (``core.collectives``) plan on it.  The JAX package's TPU links
(ICI, DCN) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Bandwidth/latency of one node-to-node link."""

    bandwidth: float  # bytes / second
    latency: float  # seconds

    def transfer_time(self, nbytes: float) -> float:
        return self.latency + nbytes / self.bandwidth


# Paper testbed: m5.4xlarge, 10 Gb/s, ~125 us estimated p2p latency.
EC2_LINK = LinkSpec(bandwidth=10e9 / 8, latency=125e-6)

# One exchange between two of four rank processes on the machine of one
# NVIDIA H100 80GB HBM3 (power limit 700.00 W), CUDA tensor to CUDA tensor
# through pinned host buffers and gloo: latency from a 1 KiB message,
# bandwidth from a 64 MiB one, each half the median ping-pong.  Measured by
# `python -m repro_torch.launch.sync --arch qwen3-14b --ranks 4` on
# that card; chip_smoke.py measures and prints it again on every run.
HOST_STAGED_LINK = LinkSpec(bandwidth=2.162e9, latency=480.1e-6)


def use_two_dimensional(n: int, link: LinkSpec, size: float) -> bool:
    """Paper condition: two-dimensional chain iff n * B * L > S."""
    return n * link.bandwidth * link.latency > size


# ---------------------------------------------------------------------------
# Chain selection (Appendix A)
# ---------------------------------------------------------------------------


def t_1d(n: int, link: LinkSpec, size: float) -> float:
    """Pipelined 1-D chain completion time (Appendix A)."""
    return size / link.bandwidth + (n - 1) * link.latency


def t_2d(n: int, link: LinkSpec, size: float) -> float:
    return 2 * size / link.bandwidth + 2 * (math.isqrt(n) - 1) * link.latency


def predicted_reduce_time(n: int, link: LinkSpec, size: float) -> float:
    return min(t_1d(n, link, size), t_2d(n, link, size)) if n > 1 else 0.0


# ---------------------------------------------------------------------------
# Recursive chain plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChainPlan:
    """A (possibly recursive) reduce plan over abstract slot indices.

    ``groups`` is a list of index groups; each group is reduced by a 1-D
    chain (in arrival order at run time), and the group results are then
    chained together.  A plan with a single group is a plain 1-D chain.
    Nested plans (``subplans``) realize the O(log log n) recursion.
    """

    indices: List[int]
    groups: List[List[int]]
    subplans: List["ChainPlan"]
    depth: int

    @property
    def is_flat(self) -> bool:
        return len(self.groups) == 1

    def chain_lengths(self) -> List[int]:
        out = []
        if self.subplans:
            for sp in self.subplans:
                out.extend(sp.chain_lengths())
            out.append(len(self.groups))
        else:
            out.append(len(self.indices))
        return out


def plan_reduce(
    indices: Sequence[int],
    link: LinkSpec,
    size: float,
    rng=None,
    _depth: int = 0,
) -> ChainPlan:
    """Build the (recursive) chain plan for reducing ``indices``.

    Paper section 4.3: "The receiver node randomly partitions the n input
    objects into sqrt(n) subsets. It picks one node from each partition to
    recursively coordinate a one-dimensional reduce chain. ... Each chain of
    sqrt(n) objects can recursively break down into smaller chains until
    m B L <= S. Overall, a reduce breaks down O(log log n) times."
    """
    import random

    indices = list(indices)
    n = len(indices)
    if n <= 2 or not use_two_dimensional(n, link, size):
        return ChainPlan(indices=indices, groups=[indices], subplans=[], depth=_depth)

    rng = rng or random.Random(0)
    shuffled = list(indices)
    rng.shuffle(shuffled)
    k = max(2, math.isqrt(n))  # number of groups ~ sqrt(n)
    groups: List[List[int]] = [[] for _ in range(k)]
    for i, idx in enumerate(shuffled):
        groups[i % k].append(idx)
    groups = [g for g in groups if g]

    subplans = []
    for g in groups:
        # Recurse: each group's chain may itself split (until m B L <= S).
        subplans.append(plan_reduce(g, link, size, rng=rng, _depth=_depth + 1))
    return ChainPlan(indices=indices, groups=groups, subplans=subplans, depth=_depth)


def plan_depth(plan: ChainPlan) -> int:
    if not plan.subplans:
        return 0
    return 1 + max(plan_depth(sp) for sp in plan.subplans)


def max_chain_length(plan: ChainPlan) -> int:
    return max(plan.chain_lengths())


# ---------------------------------------------------------------------------
# Broadcast model (for analysis / tests; the broadcast itself is fully
# decentralized at run time -- see scheduler.select_sender)
# ---------------------------------------------------------------------------


def t_pipelined_multicast(n_receivers: int, link: LinkSpec, size: float, chunk: float) -> float:
    """Completion time of Hoplite's receiver-driven broadcast when all
    receivers are ready: behaves like a pipelined relay chain/tree where
    every node sends to at most one peer at a time.  With chunked
    pipelining the dominant term is S/B; each additional hop adds one
    chunk's serialization + link latency."""
    hops = max(1, math.ceil(math.log2(n_receivers + 1)))
    return size / link.bandwidth + (hops - 1) * (link.latency + chunk / link.bandwidth)


def t_binomial_store_forward(n_receivers: int, link: LinkSpec, size: float) -> float:
    """MPI-style binomial broadcast WITHOUT pipelining: ceil(log2(n+1))
    rounds, each a full store-and-forward object transfer."""
    rounds = math.ceil(math.log2(n_receivers + 1))
    return rounds * link.transfer_time(size)


@dataclasses.dataclass(frozen=True)
class BroadcastPolicy:
    """Broadcast-tree shape for one (n_receivers, link, size) point.

    ``max_out_degree`` caps *concurrent* outbound transfers per node (the
    directory's load accounting enforces it); receivers self-organize into
    a tree of that fan-out by chasing partial-copy watermarks.
    """

    strategy: str  # "pipelined" | "binomial"
    max_out_degree: int


def t_fused_allreduce(
    n_nodes: int, link: LinkSpec, size: float, chunk: float = 4 * 1024
) -> float:
    """Fused pipelined allreduce bound (paper sections 4.3-4.4 composed):
    broadcast receivers chase the reduce target's watermark while the
    root is still reducing into it, so completion is the reduce time plus
    ONE broadcast pipeline fill -- tree-depth hops of one chunk's
    serialization + latency each -- instead of reduce plus a full
    broadcast serialized behind it."""
    n = max(1, n_nodes)
    if n == 1:
        return 0.0
    hops = math.ceil(math.log2(n))
    return predicted_reduce_time(n, link, size) + hops * (
        link.latency + chunk / link.bandwidth
    )


def t_sequential_allreduce(
    n_nodes: int, link: LinkSpec, size: float, chunk: float = 4 * 1024
) -> float:
    """Reduce-then-broadcast with a completion barrier between the two
    (the pre-fusion composition): the broadcast cannot start before the
    last reduced byte exists."""
    n = max(1, n_nodes)
    if n == 1:
        return 0.0
    recv = n - 1
    bp = broadcast_policy(recv, link, size, chunk=chunk)
    if bp.strategy == "pipelined":
        t_b = t_pipelined_multicast(recv, link, size, chunk)
    else:
        t_b = t_binomial_store_forward(recv, link, size)
    return predicted_reduce_time(n, link, size) + t_b


@dataclasses.dataclass(frozen=True)
class AllreducePolicy:
    """Whether to fuse the reduce->broadcast pipeline for one
    (n_nodes, link, size) point, plus the broadcast-tree shape the
    receivers use either way."""

    fused: bool
    broadcast: BroadcastPolicy
    t_fused: float
    t_sequential: float


def allreduce_policy(
    n_nodes: int,
    link: LinkSpec,
    size: float,
    chunk: float = 4 * 1024,
    egress_sharing: bool = True,
) -> AllreducePolicy:
    """Shared by the discrete-event simulator and ``LocalCluster``:
    fuse whenever the closed forms say overlap wins.  Small (inline-able)
    objects never fuse -- the directory answers them in one round trip at
    completion, and there is no partial copy to chase."""
    from repro_torch.core.api import SMALL_OBJECT_THRESHOLD

    n = max(1, n_nodes)
    bp = broadcast_policy(
        max(1, n - 1), link, size, chunk=chunk, egress_sharing=egress_sharing
    )
    t_f = t_fused_allreduce(n, link, size, chunk)
    t_s = t_sequential_allreduce(n, link, size, chunk)
    fused = n > 1 and size >= SMALL_OBJECT_THRESHOLD and t_f < t_s
    return AllreducePolicy(fused=fused, broadcast=bp, t_fused=t_f, t_sequential=t_s)


def broadcast_policy(
    n_receivers: int,
    link: LinkSpec,
    size: float,
    chunk: float = 4 * 1024,
    egress_sharing: bool = True,
) -> BroadcastPolicy:
    """Pick the broadcast-tree shape by comparing the two closed forms.

    Bandwidth-bound regime (``t_pipelined_multicast`` wins: large objects)
    -> a deep pipelined tree with small fan-out, so no sender divides its
    outbound bandwidth too many ways and the origin sheds every receiver
    past its first ``max_out_degree`` onto first-generation partial copies.

    Latency-bound regime (``t_binomial_store_forward`` wins: small objects,
    chunk serialization ~ latency) -> a shallow bushy tree: fan-out
    ~log2(n+1) trades per-link bandwidth for fewer relay hops.

    ``egress_sharing`` describes the transport: True when a node's
    concurrent sends split one egress pipe (the simulator's FIFO NIC, the
    paper's EC2 testbed -- pipelined fan-out 1, exactly the paper's
    one-outbound-transfer rule); False when per-send capacity is
    independent (the threaded cluster's paced streams, multi-queue NICs
    -- fan-out 2 halves tree depth at no per-send cost).

    Shared verbatim by the discrete-event simulator and ``LocalCluster``.
    """
    n = max(1, n_receivers)
    if n == 1:
        return BroadcastPolicy("pipelined", 1)
    # The emergent tree's depth is unknown at planning time, so score the
    # pipelined candidate at its chain-degenerate bound (depth n-1, the
    # t_pipelined_multicast family with worst-case hops) against the
    # binomial store-and-forward rounds: with chunked pipelining an extra
    # hop costs one chunk + L, while a binomial round costs a whole
    # object -- the forms cross where (n-1)(L + c/B) ~ log2(n+1) * S/B.
    t_pipe = size / link.bandwidth + (n - 1) * (link.latency + chunk / link.bandwidth)
    t_bin = t_binomial_store_forward(n, link, size)
    if t_pipe <= t_bin:
        return BroadcastPolicy("pipelined", 1 if egress_sharing else 2)
    return BroadcastPolicy("binomial", max(2, math.ceil(math.log2(n + 1))))


# ---------------------------------------------------------------------------
# Elastic member-set re-splice policy (shared by both planes)
# ---------------------------------------------------------------------------

# splice_mode outcomes: how a mid-chain member delta (a joiner's
# contribution arriving under a later membership epoch) is absorbed.
SPLICE_TAIL = "tail"      # splice into the chain tail (ChainState.splice_source)
SPLICE_SIDE = "side"      # fold as a late side-contribution at finalization
SPLICE_REJECT = "reject"  # too late: the fold frontier already passed


def splice_mode(
    chain_active: bool,
    fold_frontier: int,
    size: float,
) -> str:
    """Where a joiner's contribution can still enter an in-flight reduce.

    The chain contract is epoch-versioned: contributions that were in the
    member set at chain start ride ``ChainState.on_ready``; a later epoch's
    contribution must be *spliced*.  While the arrival-order chain is still
    consuming sources (``chain_active``), the joiner simply becomes the new
    tail -- its watermark can catch the fold frontier because the tail hop
    has not been issued yet (``SPLICE_TAIL``).  Once the chain closed but
    the receiver's final fold has not yet written its first window
    (``fold_frontier == 0``), the contribution folds as an extra operand of
    the finalization fold -- associativity/commutativity of the elementwise
    op makes the result exact (``SPLICE_SIDE``).  After the frontier moved
    (``fold_frontier > 0``) bytes below the output watermark are immutable
    and may already have been copied by chasing consumers, so the splice is
    rejected (``SPLICE_REJECT``) -- the caller folds the late contribution
    outside the collective or re-runs it.

    Shared by ``LocalCluster.splice_contribution`` and the simulator's
    ``Hoplite`` so both planes make the identical tail/side/reject call.
    """
    if chain_active:
        return SPLICE_TAIL
    if fold_frontier <= 0:
        return SPLICE_SIDE
    return SPLICE_REJECT


def bounded_time_participants(n: int, min_participants=None) -> int:
    """Participation quorum k for a bounded-time allreduce over ``n``
    contributions.  Default is k = n - 1 -- tolerate exactly one
    straggler, the dominant cloud tail shape (OptiReduce's observation:
    p99 is set by the single slowest participant, and dropping one
    contribution bounds the gradient-staleness cost at 1/n).  Clamped to
    [1, n]; k = n degenerates to the unbounded collective."""
    k = (n - 1) if min_participants is None else int(min_participants)
    return max(1, min(n, k))
