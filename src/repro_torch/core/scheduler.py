"""Receiver-driven coordination (paper section 4.3).

Pure protocol state machines, shared by the discrete-event simulator
(core/simulation.py) and the threaded in-process cluster (core/local.py):

  * ``select_source`` is the adaptive broadcast sender policy: among ALL
    copies of an object (complete and in-flight partial) pick the
    least-loaded feasible one -- feasible meaning its watermark *leads*
    the receiver's own progress, so a partial copy can be chased
    chunk-by-chunk but an empty peer can never be picked (which would
    form a dependency cycle).  ``ObjectDirectory.select_source`` applies
    it against the live location table plus per-node outbound-load
    counters; ``checkout_location`` remains as the paper's original
    one-outbound-transfer special case;

  * ``ChainState`` implements the arrival-order 1-D reduce chain: the
    coordinator observes source objects becoming ready and emits *hop*
    instructions ("node holding the current partial result streams it to
    the newly-ready node, which reduces it with its local object");

  * ``partition_groups`` implements the 2-D (sqrt-n) random partition.

The paper's worked example (section 4.3) is encoded as a unit test:
objects a,b,c,d on nodes A,B,C,D, receiver D, arrival order a,d,c,b =>
hops A->C (a+c), C->B (a+b+c), B->D (final).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.api import Location, Progress


def select_source(
    candidates: Sequence[Location],
    *,
    loads: Dict[int, int],
    served: Optional[Dict[int, int]] = None,
    min_lead: int = 0,
    max_out_degree: Optional[int] = None,
    tick: int = 0,
    avoid: FrozenSet[int] = frozenset(),
) -> Optional[Location]:
    """Least-loaded feasible source for one receiver-driven fetch.

    A candidate is *feasible* when it is COMPLETE or its watermark
    strictly leads the receiver's progress (``bytes_present > min_lead``):
    a copy at or behind the receiver can never feed it, and picking one
    could close a wait-for cycle between two chasing partials.

    Among feasible candidates with outbound load below ``max_out_degree``
    (None = uncapped) the least-loaded wins; ties prefer the holder that
    has *served this object the fewest times* (``served``) -- the origin
    sheds post-storm requests onto first-generation receivers instead of
    being recycled the moment its slots free -- then COMPLETE copies,
    then a rotating counter so repeated broadcasts spread across
    equally-placed holders.  ``avoid`` is a *soft* penalty, not a
    feasibility filter: nodes the receiver already stalled on sort after
    every other feasible candidate but can still be picked when nothing
    else exists -- eviction must never turn a slow fetch into a stuck
    one.  Returns None when every feasible source is at its cap (the
    caller waits for a slot) or no candidate is feasible yet (the caller
    waits for a watermark).
    """
    served = served or {}
    feasible = [
        l
        for l in candidates
        if l.progress is Progress.COMPLETE or l.bytes_present > min_lead
    ]
    if max_out_degree is not None:
        feasible = [l for l in feasible if loads.get(l.node, 0) < max_out_degree]
    if not feasible:
        return None
    return min(
        feasible,
        key=lambda l: (
            l.node in avoid,
            loads.get(l.node, 0),
            served.get(l.node, 0),
            l.progress is not Progress.COMPLETE,
            (l.node + tick) % 1000003,
        ),
    )


@dataclasses.dataclass
class Hop:
    """One reduce-chain hop: ``src_node`` streams the current partial
    result object into ``dst_node``, which reduces it with its local
    ready object ``dst_object`` to produce ``out_object``."""

    src_node: int
    src_object: str
    dst_node: int
    dst_object: str
    out_object: str


class ChainState:
    """Arrival-order 1-D chain coordinator.

    The receiver folds its *own* local source objects at the very end (the
    paper avoids early transfers into the final destination: "the receiver
    node does not immediately reduce these together, since this would
    result in an additional transfer to node D").
    """

    def __init__(self, receiver_node: int, tag: str = "red", epoch: int = 0):
        self.receiver_node = receiver_node
        self.tag = tag
        # Membership epoch snapshot at chain creation.  Member deltas that
        # land mid-chain (add_node / drain_node) bump the cluster epoch and
        # re-splice the chain through ``splice_source`` / the drain handoff,
        # recorded here so the trace can attribute every divergence from
        # the start-time member set to an epoch transition.
        self.epoch = epoch
        self.splices_join = 0
        self.splices_drain = 0
        # (epoch, kind, object_id) per member-change splice, in order.
        self.member_events: List[Tuple[int, str, str]] = []
        self._tail: Optional[Tuple[int, str]] = None  # (node, object_id)
        self._local: List[str] = []  # receiver-local ready objects
        self._hops = 0
        # Contribution lineage: hop output -> (upstream partial, local
        # source) folded into it, in ``op(a, b)`` argument order.  A
        # consumer that loses its upstream mid-stream walks this map to
        # re-fold exactly the lost prefix from still-live copies (the
        # re-splice path) -- same association order, so byte-identical.
        self.lineage: Dict[str, Tuple[str, str]] = {}

    @property
    def tail(self) -> Optional[Tuple[int, str]]:
        return self._tail

    @property
    def local_objects(self) -> List[str]:
        return list(self._local)

    def on_ready(self, node: int, object_id: str) -> Optional[Hop]:
        """A source object became ready at ``node``.  Returns the hop to
        issue now, or None (first non-receiver object / receiver-local)."""
        if node == self.receiver_node:
            self._local.append(object_id)
            return None
        if self._tail is None:
            self._tail = (node, object_id)
            return None
        src_node, src_object = self._tail
        self._hops += 1
        out_object = f"{self.tag}-hop{self._hops}-{object_id}"
        hop = Hop(src_node, src_object, node, object_id, out_object)
        self.lineage[out_object] = (src_object, object_id)
        self._tail = (node, out_object)
        return hop

    def splice_source(self, node: int, object_id: str, epoch: int) -> Optional[Hop]:
        """Member-change tail splice: admit a contribution that was NOT in
        the chain's start-time member set (a joiner that arrived under a
        later membership ``epoch``).  Mechanically identical to
        :meth:`on_ready` -- the joiner becomes the new chain tail, its fold
        recorded in ``lineage`` with the same ``op(a, b)`` association any
        original member would get -- but counted and logged as a join
        splice so the trace can equate splice instants with the
        ``splices_join`` stat."""
        self.splices_join += 1
        self.member_events.append((epoch, "join", object_id))
        self.epoch = epoch
        return self.on_ready(node, object_id)

    def splice_side(self, object_id: str, epoch: int) -> None:
        """Member-change side splice: the contribution arrived after the
        chain closed and folds as an extra operand of the receiver's
        finalization fold instead -- exact by associativity/commutativity
        of the elementwise op.  Bookkeeping only; the receiver streams the
        contribution itself."""
        self.splices_join += 1
        self.member_events.append((epoch, "join", object_id))
        self.epoch = epoch

    def note_drain_handoff(self, object_id: str, epoch: int) -> None:
        """Member-change drain splice: the holder of ``object_id`` (a chain
        partial, possibly still producing) left via ``drain_node`` and its
        chain position was handed to a successor -- the fold resumed from
        the evacuated copy or the lineage re-fold, byte-identically.
        Bookkeeping only; the consumer performs the actual re-splice."""
        self.splices_drain += 1
        self.member_events.append((epoch, "drain", object_id))
        self.epoch = epoch

    def final_hop(self, final_object: str) -> Optional[Hop]:
        """All sources ready: stream the tail into the receiver (which then
        folds its local objects).  None if everything was receiver-local."""
        if self._tail is None:
            return None
        src_node, src_object = self._tail
        return Hop(src_node, src_object, self.receiver_node, "<local>", final_object)


def partition_groups(
    items: Sequence, rng: Optional[random.Random] = None, num_groups: Optional[int] = None
) -> List[List]:
    """Randomly partition ``items`` into ~sqrt(n) groups (paper 4.3)."""
    items = list(items)
    n = len(items)
    if n <= 2:
        return [items]
    rng = rng or random.Random(0)
    k = num_groups or max(2, math.isqrt(n))
    shuffled = list(items)
    rng.shuffle(shuffled)
    groups: List[List] = [[] for _ in range(k)]
    for i, it in enumerate(shuffled):
        groups[i % k].append(it)
    return [g for g in groups if g]
