"""Object directory service (paper section 4.1).

A sharded hash table mapping ObjectID -> {size, locations}.  Each location
carries a progress bit (PARTIAL / COMPLETE) plus a byte watermark.  The
directory:

  * answers synchronous and asynchronous ("publish future locations to the
    client") location queries; subscriptions fire on partial-copy
    registration and on watermark advances, not just on COMPLETE,
  * selects senders adaptively: ``select_source`` returns the least-loaded
    copy whose watermark leads the receiver's progress and charges the
    holder's outbound-load counter until ``release_source`` -- this caps
    every node at the broadcast policy's out-degree and is what makes the
    receiver-driven multicast tree emerge on the fly (section 4.3);
    ``checkout_location`` remains as the original one-outbound-transfer
    special case (still used by some tests/baselines),
  * inlines small objects (< 64 KB) directly (section 4.1),
  * can be replicated for fault tolerance (section 7); replicas apply the
    same update stream and a failover promotes a replica to primary.
    Outbound-load counters are *client* state (like subscriptions): they
    live on the serving primary and survive promotion untouched.

This is a *control plane* component: it is used verbatim by both the
discrete-event simulator and the threaded in-process cluster.
"""

from __future__ import annotations

import collections
import zlib
from typing import Callable, Dict, List, Optional

from repro_torch.core.api import (
    Location,
    ObjectLost,
    Progress,
    SMALL_OBJECT_THRESHOLD,
)
from repro_torch.core import scheduler as _scheduler

# Per-shard tombstone bound (see _Shard.deleted).
_TOMBSTONES_PER_SHARD = 4096


class _Shard:
    """One directory shard: ObjectID -> entry."""

    def __init__(self):
        self.size: Dict[str, int] = {}
        self.locations: Dict[str, Dict[int, Location]] = collections.defaultdict(dict)
        self.inline: Dict[str, object] = {}  # small-object fast path
        self.subscribers: Dict[str, List[Callable]] = collections.defaultdict(list)
        # Locations temporarily checked out by an in-flight transfer.
        self.checked_out: Dict[str, Dict[int, Location]] = collections.defaultdict(dict)
        # Per-object send tallies: object id -> {node -> times selected as
        # source}.  Selection tie-break so repeat requests spread across
        # every holder instead of recycling the origin once its slots free
        # up; dropped with the entry on delete.
        self.sends: Dict[str, Dict[int, int]] = collections.defaultdict(dict)
        # Tombstones: deleted object ids.  A transfer that was in flight
        # when Delete arrived must not silently re-add the object when it
        # checks its location back in / publishes completion.  Bounded
        # FIFO: ids are unique-per-object, so a tombstone only matters for
        # the lifetime of transfers that started before the Delete; capping
        # keeps week-long serving runs from accreting one entry per request.
        self.deleted: "collections.OrderedDict[str, None]" = collections.OrderedDict()


class ObjectDirectory:
    """Sharded object directory service."""

    def __init__(self, num_shards: int = 8, seed: int = 0):
        self.num_shards = num_shards
        self.shards = [_Shard() for _ in range(num_shards)]
        self._tick = 0  # deterministic tie-break counter
        # Per-node outbound-load counters (concurrent sends charged by
        # select_source, released by release_source).  Client-side state
        # like subscriptions: not replicated, survives primary failover.
        self._outbound: Dict[int, int] = collections.defaultdict(int)
        # Charge epochs: bumped when a node's outbound state is reset
        # (fail/restart).  A release tagged with a stale epoch must NOT
        # decrement charges that belong to the node's post-restart
        # streams, or the out-degree cap invariant silently breaks.
        self._node_epoch: Dict[int, int] = collections.defaultdict(int)
        # node -> object ids whose receivers found a feasible source on
        # that node but were turned away by the out-degree cap; notified
        # (and cleared) when the node frees a slot.  Targeted registry so
        # release_source never has to scan the subscriber tables.
        self._cap_blocked: Dict[int, set] = {}
        # Nodes winding down before a planned departure (drain_node):
        # select_source soft-avoids them like stalled holders so fresh
        # receivers shed onto staying nodes while in-flight transfers
        # finish naturally.
        self._draining: set = set()
        # Optional core.trace.FlightRecorder, attached by the owning
        # cluster (never by replicas -- mirrored mutations must not
        # double-record).  Checked as `enabled` before any event cost.
        self.recorder = None

    # -- internal ----------------------------------------------------------

    def _shard(self, object_id: str) -> _Shard:
        return self.shards[self.shard_index(object_id)]

    def shard_index(self, object_id: str) -> int:
        """Stable shard routing.  The builtin ``hash`` is
        PYTHONHASHSEED-randomized, so it diverges across processes --
        transport peers and restarted directories must agree on the
        id -> shard mapping (``fail_primary`` carries subscriber tables
        across shards positionally, and a multi-process plane routes
        directory RPCs by shard).  crc32 is deterministic everywhere."""
        return zlib.crc32(object_id.encode("utf-8")) % self.num_shards

    def _notify(self, shard: _Shard, object_id: str) -> None:
        for cb in list(shard.subscribers.get(object_id, ())):
            cb(object_id)

    # -- publishing --------------------------------------------------------

    def publish_partial(
        self,
        object_id: str,
        node: int,
        size: Optional[int] = None,
        producing: bool = False,
    ) -> None:
        """A node is *about to* hold this object (Put started / transfer
        started).  Partial copies can act as senders (section 4.2).

        ``producing`` marks the copy as *generated* at ``node`` (a reduce
        target being reduced into) rather than relayed: consumers may
        stream from it before any complete copy exists, and the stuck-
        cohort detector must never declare it lost while its node lives.
        A re-publish keeps the existing watermark (planners refresh it
        from the store buffer anyway) and is producing-sticky."""
        shard = self._shard(object_id)
        if object_id in shard.deleted:
            return
        if size is not None:
            shard.size[object_id] = size
        loc = shard.locations[object_id].get(node)
        if loc is None:
            shard.locations[object_id][node] = Location(
                node, Progress.PARTIAL, 0, producing=producing
            )
        elif loc.progress is Progress.PARTIAL and producing:
            loc.producing = True
        self._notify(shard, object_id)

    def publish_complete(self, object_id: str, node: int, size: int) -> None:
        shard = self._shard(object_id)
        if object_id in shard.deleted:
            return
        shard.size[object_id] = size
        shard.locations[object_id][node] = Location(node, Progress.COMPLETE, size)
        self._notify(shard, object_id)

    def publish_inline(self, object_id: str, value, size: int) -> None:
        """Small-object fast path: cache the object in the directory."""
        assert size < SMALL_OBJECT_THRESHOLD
        shard = self._shard(object_id)
        shard.inline[object_id] = value
        shard.size[object_id] = size
        self._notify(shard, object_id)

    def update_progress(self, object_id: str, node: int, bytes_present: int) -> None:
        """Advance a partial copy's watermark.  Subscribers are woken on
        the 0 -> positive transition only -- the moment this copy becomes
        a *feasible* source for fresh receivers.  Waking them on every
        subsequent window would stampede all blocked receivers through
        the planner once per window (O(windows x receivers) wakeups);
        later re-plans observe current watermarks directly at query time,
        and completion/release events cover the remaining wake-ups."""
        shard = self._shard(object_id)
        locs = shard.locations.get(object_id)
        loc = locs.get(node) if locs else None
        if loc is not None and bytes_present > loc.bytes_present:
            became_feasible = loc.bytes_present == 0
            loc.bytes_present = bytes_present
            if became_feasible:
                self._notify(shard, object_id)

    # -- queries -----------------------------------------------------------

    def size_of(self, object_id: str) -> Optional[int]:
        return self._shard(object_id).size.get(object_id)

    def get_inline(self, object_id: str):
        return self._shard(object_id).inline.get(object_id)

    def locations(self, object_id: str) -> List[Location]:
        shard = self._shard(object_id)
        entry = shard.locations.get(object_id)
        return list(entry.values()) if entry else []

    # -- adaptive source selection (receiver-driven broadcast trees) -------

    def select_source(
        self,
        object_id: str,
        *,
        exclude: Optional[int] = None,
        min_lead: int = 0,
        max_out_degree: Optional[int] = None,
        dead=frozenset(),
        avoid=frozenset(),
    ) -> Optional[Location]:
        """Least-loaded copy whose watermark leads ``min_lead`` (section
        4.2: a receiver may fetch from ANY node holding the object,
        including one whose copy is still in flight).

        Unlike :meth:`checkout_location` the location stays visible; the
        holder's outbound-load counter is charged instead, capping each
        node at ``max_out_degree`` *concurrent* sends.  The caller MUST
        pair every non-None return with :meth:`release_source`.

        ``avoid`` soft-deprioritizes nodes the receiver already stalled
        on (see ``scheduler.select_source``) -- they lose every tie but
        remain pickable when no other copy exists.
        """
        shard = self._shard(object_id)
        locs = shard.locations.get(object_id)
        if not locs:
            return None
        candidates = [
            l
            for l in locs.values()
            if l.node != exclude and l.node not in dead
        ]
        if self._draining:
            # Draining holders lose every tie (soft avoidance, same
            # mechanism as stalled sources) but stay pickable when they
            # hold the only copy.
            avoid = frozenset(avoid) | self._draining
        self._tick += 1
        served = shard.sends.get(object_id, {})
        chosen = _scheduler.select_source(
            candidates,
            loads=self._outbound,
            served=served,
            min_lead=min_lead,
            max_out_degree=max_out_degree,
            tick=self._tick,
            avoid=avoid,
        )
        rec = self.recorder
        if chosen is not None:
            self._outbound[chosen.node] += 1
            shard.sends[object_id][chosen.node] = served.get(chosen.node, 0) + 1
            if rec is not None and rec.enabled:
                rec.instant(
                    "directory", "select-source", chosen.node, object_id,
                    load=self._outbound[chosen.node], min_lead=min_lead,
                )
        elif max_out_degree is not None:
            # Turned away by the cap, not by feasibility: register
            # interest on every feasible holder so the next freed slot on
            # any of them wakes this object's waiters (targeted -- no
            # subscriber-table scans at release time).
            turned_away = False
            for l in candidates:
                if l.progress is Progress.COMPLETE or l.bytes_present > min_lead:
                    self._cap_blocked.setdefault(l.node, set()).add(object_id)
                    turned_away = True
            if turned_away and rec is not None and rec.enabled:
                rec.instant(
                    "directory", "cap-blocked", exclude if exclude is not None else -1,
                    object_id, max_out_degree=max_out_degree,
                )
        return chosen

    def release_source(self, object_id: str, node: int, epoch: Optional[int] = None) -> None:
        """Transfer off ``node`` finished (or failed): free its outbound
        slot and wake blocked receivers so they re-plan promptly.

        ``epoch`` is the value of :meth:`charge_epoch` captured when the
        slot was charged; a release from a stream that predates the
        node's last fail/restart must not decrement charges belonging to
        its post-restart streams (the out-degree cap invariant).

        The outbound cap is per NODE, shared across objects -- a freed
        slot can unblock a receiver of any *other* object this node also
        holds; those waiters registered themselves in ``_cap_blocked``
        at selection time and are notified here, once per transfer."""
        if epoch is None or epoch == self._node_epoch.get(node, 0):
            if self._outbound.get(node, 0) > 0:
                self._outbound[node] -= 1
        rec = self.recorder
        if rec is not None and rec.enabled:
            rec.instant(
                "directory", "release-source", node, object_id,
                load=self._outbound.get(node, 0),
            )
        self._notify(self._shard(object_id), object_id)
        for oid in self._cap_blocked.pop(node, ()):
            if oid != object_id:
                self._notify(self._shard(oid), oid)

    def charge_epoch(self, node: int) -> int:
        """Capture alongside a select_source charge; pass to release_source."""
        return self._node_epoch.get(node, 0)

    def charge_source(self, object_id: str, node: int) -> int:
        """Charge one outbound slot on ``node`` for a stream that was NOT
        planned through :meth:`select_source` (reduce-chain hops): the
        node's egress is busy either way, and the shared load counter is
        what lets broadcast receivers shed onto reduce-idle holders.
        Returns the charge epoch; pair with :meth:`release_source` -- a
        release after the node's fail/restart becomes a no-op, so a dead
        hop can never free a slot charged by post-restart streams."""
        self._outbound[node] += 1
        return self._node_epoch.get(node, 0)

    def reset_outbound(self, node: int) -> None:
        """Node failed or restarted: its in-flight sends are gone.  Zero
        the load counter and bump the epoch so late releases from the
        pre-reset streams become no-ops."""
        self._node_epoch[node] = self._node_epoch.get(node, 0) + 1
        self._outbound.pop(node, None)
        self._cap_blocked.pop(node, None)

    def outbound_load(self, node: int) -> int:
        return self._outbound.get(node, 0)

    # -- elastic membership --------------------------------------------------

    def set_draining(self, node: int, draining: bool = True) -> None:
        """Mark/unmark a node as winding down: ``select_source`` soft-
        avoids its copies from now on (they lose every tie but remain
        pickable as the sole source)."""
        if draining:
            self._draining.add(node)
        else:
            self._draining.discard(node)

    def is_draining(self, node: int) -> bool:
        return node in self._draining

    def objects_at(self, node: int) -> List[str]:
        """Every object id with a location at ``node`` -- the drain
        evacuation's work list.  Checked-out copies count too: a copy
        serving as a broadcast source is withheld from ``locations`` for
        the duration of the stream, and under load that is exactly when
        drain runs."""
        out = []
        for shard in self.shards:
            for object_id, locs in shard.locations.items():
                if node in locs:
                    out.append(object_id)
            for object_id, locs in shard.checked_out.items():
                if node in locs and object_id not in out:
                    out.append(object_id)
        return out

    def sole_holder(self, object_id: str, node: int) -> bool:
        """True when ``node`` holds the only COMPLETE copy (no inline
        cache, no other complete live or checked-out location): losing it
        would lose the object.  Partial receiver copies elsewhere do NOT
        count -- a partial can only finish by pulling its remaining bytes
        from a copy whose watermark leads it, so once the last complete
        copy dies the whole partial cohort is stuck (this is exactly the
        race drain evacuation must not lose against in-flight fetches)."""
        shard = self._shard(object_id)
        if object_id in shard.inline:
            return False
        for pool in (shard.locations, shard.checked_out):
            for n, loc in pool.get(object_id, {}).items():
                if n != node and loc.progress is Progress.COMPLETE:
                    return False
        return True

    def producing_at(self, object_id: str, node: int) -> bool:
        """True when ``node`` holds a *producing* partial of
        ``object_id`` -- a reduce-chain target/hop output still being
        generated locally.  The drain handoff's work-list predicate:
        ``sole_holder`` deliberately ignores partials (a receiver copy
        elsewhere can finish from another source), but a producing partial
        IS the chain's only accumulated state, so a drain must hand it
        off -- wait for local completion and evacuate -- rather than
        leave with it."""
        for pool in (self._shard(object_id).locations,
                     self._shard(object_id).checked_out):
            loc = pool.get(object_id, {}).get(node)
            if loc is not None and loc.producing:
                return True
        return False

    def checkout_location(
        self, object_id: str, *, remove: bool = True, exclude: Optional[int] = None
    ) -> Optional[Location]:
        """Return ONE location, preferring complete copies (section 4.3).

        With ``remove=True`` the location is withheld from subsequent
        queries until :meth:`return_location` is called -- this is the
        mechanism that caps each node at one concurrent outbound transfer
        and turns late receivers into a dynamically-built broadcast tree.
        """
        shard = self._shard(object_id)
        locs = [
            l
            for l in shard.locations[object_id].values()
            if exclude is None or l.node != exclude
        ]
        if not locs:
            return None
        # Prefer complete copies; break ties deterministically by a rotating
        # counter so repeated broadcasts spread load.
        self._tick += 1
        locs.sort(key=lambda l: (l.progress is not Progress.COMPLETE, (l.node + self._tick) % 1000003))
        chosen = locs[0]
        if remove:
            del shard.locations[object_id][chosen.node]
            shard.checked_out[object_id][chosen.node] = chosen
        return chosen

    def return_location(self, object_id: str, node: int) -> None:
        """Add a checked-out sender back (transfer finished).  A location
        whose object was deleted while checked out is dropped, not
        re-added."""
        shard = self._shard(object_id)
        loc = shard.checked_out[object_id].pop(node, None)
        if object_id in shard.deleted:
            return
        if loc is not None and node not in shard.locations[object_id]:
            shard.locations[object_id][node] = loc
            self._notify(shard, object_id)

    # -- async queries -----------------------------------------------------

    def subscribe(self, object_id: str, callback: Callable) -> None:
        """Asynchronous location query: callback fires on every new
        location publication for ``object_id`` (section 4.1)."""
        shard = self._shard(object_id)
        shard.subscribers[object_id].append(callback)
        if shard.locations[object_id] or object_id in shard.inline:
            callback(object_id)

    def unsubscribe(self, object_id: str, callback: Callable) -> None:
        shard = self._shard(object_id)
        lst = shard.subscribers.get(object_id)
        if lst is None:
            return
        try:
            lst.remove(callback)
        except ValueError:
            pass
        if not lst:
            # Drop the emptied key: with per-request object ids, leaving
            # one empty list per id ever waited on accretes without bound
            # (same concern as the tombstone cap above).
            shard.subscribers.pop(object_id, None)

    # -- deletion / failures -------------------------------------------------

    def delete(self, object_id: str) -> List[int]:
        """Remove all copies; returns the nodes that held one.

        Subscribers are notified BEFORE the entry is dropped: a waiter
        blocked on this object must wake and observe the deletion (it will
        see no locations and a tombstone) instead of sleeping to its
        deadline."""
        shard = self._shard(object_id)
        nodes = list(shard.locations[object_id].keys()) + list(
            shard.checked_out[object_id].keys()
        )
        shard.deleted[object_id] = None
        self._notify(shard, object_id)
        shard.locations.pop(object_id, None)
        shard.checked_out.pop(object_id, None)
        shard.inline.pop(object_id, None)
        shard.size.pop(object_id, None)
        shard.sends.pop(object_id, None)
        # Subscribers are NOT popped: a still-registered waiter (e.g. a
        # reduce source that may be revived by a re-Put) must keep
        # receiving events; each waiter unsubscribes itself when done.
        while len(shard.deleted) > _TOMBSTONES_PER_SHARD:
            shard.deleted.popitem(last=False)
        return nodes

    def drop_location(self, object_id: str, node: int) -> None:
        """Invalidate a stale location (e.g. the copy was evicted under
        capacity pressure, or an abandoned in-flight partial): remove it
        whether live or checked out, and wake the object's subscribers so
        waiters can observe the loss (possibly raising ObjectLost) instead
        of sleeping to their deadline."""
        shard = self._shard(object_id)
        locs = shard.locations.get(object_id)
        co = shard.checked_out.get(object_id)
        dropped = locs is not None and locs.pop(node, None) is not None
        dropped |= co is not None and co.pop(node, None) is not None
        if dropped:
            self._notify(shard, object_id)

    def is_available(self, object_id: str) -> bool:
        """Any copy (complete, partial, or in-flight checked-out) or inline
        entry still exists -- the non-raising form of assert_available.
        Read via .get(): subscripting the defaultdicts would re-insert an
        empty entry per queried (possibly deleted) id, accreting memory."""
        shard = self._shard(object_id)
        return bool(
            shard.locations.get(object_id)
            or shard.checked_out.get(object_id)
            or object_id in shard.inline
        )

    def available_elsewhere(self, object_id: str, node: int) -> bool:
        """Like is_available, but ignoring copies held by ``node`` itself:
        a receiver's own partial cannot feed its own fetch, so when this
        returns False the fetch can only end in ObjectLost."""
        shard = self._shard(object_id)
        if object_id in shard.inline:
            return True
        if any(n != node for n in shard.locations.get(object_id, ())):
            return True
        return any(n != node for n in shard.checked_out.get(object_id, ()))

    def is_deleted(self, object_id: str) -> bool:
        return object_id in self._shard(object_id).deleted

    def revive(self, object_id: str) -> None:
        """Clear a tombstone: the application explicitly re-Puts this id."""
        self._shard(object_id).deleted.pop(object_id, None)

    def fail_node(self, node: int) -> List[str]:
        """Drop every location on a failed node; returns object IDs that
        lost their LAST copy (the framework must recover those, section 7).

        Every object that lost a location has its subscribers notified so
        event-driven waiters re-examine the entry (and can raise
        ObjectLost immediately when the last copy vanished)."""
        orphaned = []
        affected = []
        # In-flight sends died with the node: zero its load counter and
        # bump its charge epoch so late releases from its old streams
        # cannot free slots charged by post-restart streams.
        self.reset_outbound(node)
        self._draining.discard(node)
        for shard in self.shards:
            for object_id in list(shard.locations.keys()):
                dropped = shard.locations[object_id].pop(node, None) is not None
                dropped |= shard.checked_out[object_id].pop(node, None) is not None
                if dropped:
                    affected.append((shard, object_id))
                    # Only an object that actually LOST a copy here can be
                    # orphaned by this failure: a subscribed-but-never-Put
                    # id has an (empty) location entry too, and counting it
                    # would make a drain racing a reduce whose sources are
                    # still being produced report phantom loss.
                    if (not shard.locations[object_id]
                            and not shard.checked_out[object_id]
                            and object_id not in shard.inline):
                        orphaned.append(object_id)
        for shard, object_id in affected:
            self._notify(shard, object_id)
        return orphaned

    def assert_available(self, object_id: str) -> None:
        if not self.is_available(object_id):
            raise ObjectLost(object_id)


class ReplicatedDirectory(ObjectDirectory):
    """Primary + replica directory (paper section 7: 'the object directory
    service can easily be replicated for durability').

    Every mutation is applied to the primary and mirrored to replicas.
    ``fail_primary()`` promotes replica 0.  Queries always hit the primary.
    """

    def __init__(self, num_shards: int = 8, num_replicas: int = 1):
        super().__init__(num_shards)
        self.replicas = [ObjectDirectory(num_shards) for _ in range(num_replicas)]

    def _mirror(self, method: str, *args, **kwargs):
        for r in self.replicas:
            getattr(r, method)(*args, **kwargs)

    def publish_partial(self, object_id, node, size=None, producing=False):
        super().publish_partial(object_id, node, size, producing)
        self._mirror("publish_partial", object_id, node, size, producing)

    def publish_complete(self, object_id, node, size):
        super().publish_complete(object_id, node, size)
        self._mirror("publish_complete", object_id, node, size)

    def publish_inline(self, object_id, value, size):
        super().publish_inline(object_id, value, size)
        self._mirror("publish_inline", object_id, value, size)

    def delete(self, object_id):
        nodes = super().delete(object_id)
        self._mirror("delete", object_id)
        return nodes

    def revive(self, object_id):
        super().revive(object_id)
        self._mirror("revive", object_id)

    def drop_location(self, object_id, node):
        super().drop_location(object_id, node)
        self._mirror("drop_location", object_id, node)

    def set_draining(self, node, draining=True):
        super().set_draining(node, draining)
        self._mirror("set_draining", node, draining)

    def fail_node(self, node):
        orphaned = super().fail_node(node)
        self._mirror("fail_node", node)
        return orphaned

    def fail_primary(self) -> "ObjectDirectory":
        """Simulate primary loss: promote replica 0 to primary state.

        Subscriptions are *client* state, not replicated directory state:
        carry them over to the promoted shards (same shard count, same
        hash -> shard mapping) or every blocked waiter would silently stop
        receiving publication events after failover."""
        promoted = self.replicas[0]
        for old, new in zip(self.shards, promoted.shards):
            new.subscribers = old.subscribers
        self.shards = promoted.shards
        return self
