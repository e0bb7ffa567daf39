"""Small-world driver for the explicit-state model checker.

The port's copy of the reference's ``tpu_swirld/analysis/mc/world.py``,
over the port's :class:`~tpu_swirld_torch.oracle.node.Node` and
:class:`~tpu_swirld_torch.transport.Transport`.

A :class:`World` owns the member keys, the protocol config, and a global
append-only table of every event any exploration branch has minted.  A
:class:`MCState` is the per-role *local ingest history*: for every role,
the exact sequence of event ids in the order the role ingested them,
plus each attacker branch's own chain tip.  Arrival ORDER is
deliberately part of the state — the horizon/late-witness machinery is
order-sensitive — so two schedules merge exactly when every node's local
arrival order is identical (Mazurkiewicz-trace equivalence of the
delivery schedule at event granularity).

Everything else — rounds, fame, the decided order, counters — is
recomputed from the history through the REAL oracle node: materializing
a role replays its arrivals through ``Node.add_event`` +
``Node.consensus_pass``, one event per pass (the checker's delivery
granularity), so what the checker explores is exactly the code that
ships.  Transitions likewise go through the real gossip path:
``Node.pull`` / ``Node.sync`` over a reliable
:class:`~tpu_swirld_torch.transport.Transport` with the ``on_call`` step hook
installed to record wire activity for replay determinism.

Roles
-----
- honest role ``i`` (``0 <= i < n_honest``) is member index ``i``;
- attacker branch role: forker ``k`` (member ``n_honest + k``) owns two
  branch roles holding divergent views of its own chain, mirroring
  :class:`tpu_swirld_torch.sim.DivergentForker`.  Both branches share the
  member's single deterministic genesis.

Actions (all JSON-serializable tuples)
--------------------------------------
- ``("pull", i, j)`` — honest role i pulls role j's delta (no creation;
  free).  When j is a branch role this IS the equivocation seam: the
  action chooses which branch serves the forker's endpoint.
- ``("sync", i, j)`` — pull + create one event (other-parent = j's
  member head as known to i).  Consumes one unit of the event budget.
- ``("ext", b, j)`` — branch role b pulls from honest role j and
  extends its own chain (payload tags the branch, so sibling branches
  mint distinct events at equal seq — fork pairs).  Consumes budget.
- ``("wext", b)`` — withhold-extend: branch b extends WITHOUT pulling,
  other-parent = the earliest event of the lowest-indexed other member
  it knows (maximally stale straggler shape).  Only enumerated with
  ``withhold=True``.  Consumes budget.

Determinism: every action's outcome is a pure function of
``(state, action)`` — timestamps come from the lamport clock (a function
of the local store) or ``max(parent timestamps) + 1``, payloads are
fixed tags, and the transport is reliable — which is what makes
memoization on state keys sound.  (One deliberate abstraction: an
empty pull is a true no-op — over a reliable transport serving honestly
no counter moves on an empty delta — so delivery-free actions are
pruned rather than folded into the state.)

Performance: actors are cloned (``deepcopy``) from the per-``(role,
history)`` node cache and stepped by ONE action, then unwired and
cached at the successor history — exploration is incremental, and full
replay-from-history only happens on cache eviction.  The clone/replay
equivalence is exact because materialization replays the identical
``add_event``/``consensus_pass([event])`` sequence.
"""

from __future__ import annotations

import dataclasses
import random
from collections import OrderedDict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.oracle.graph import toposort
from tpu_swirld_torch.oracle.node import Node
from tpu_swirld_torch.transport import Transport

#: materialization cache entries kept per world (nodes are rebuilt on miss)
_CACHE_CAP = 16384


class Role(NamedTuple):
    kind: str      # "honest" | "branch"
    member: int    # member index
    branch: int    # branch index within the forker (-1 for honest)


@dataclasses.dataclass(frozen=True)
class MCState:
    """Immutable world state: per-role ingest histories + branch tips.

    ``histories[r]`` is the flat tuple of event ids role r ingested, in
    arrival order (the first entry is always the role's own genesis).
    ``heads[q]`` is branch role q's own chain tip (branch order as in
    ``World.branch_roles``).  ``created`` counts non-genesis events
    minted so far (the budget).
    """

    histories: Tuple[Tuple[bytes, ...], ...]
    heads: Tuple[bytes, ...]
    created: int

    def view(self, role_index: int) -> Tuple[bytes, ...]:
        return self.histories[role_index]


class ActionResult(NamedTuple):
    state: "MCState"
    batch: Tuple[bytes, ...]
    noop: bool
    actor_role: int
    trace: Tuple[Tuple[int, int, str], ...]   # (src member, dst member, chan)


class World:
    """One bounded exploration universe (keys, config, event table)."""

    def __init__(
        self,
        n_honest: int = 3,
        n_forkers: int = 0,
        events: int = 5,
        seed: int = 0,
        withhold: bool = False,
        node_cls: Optional[type] = None,
        config: Optional[SwirldConfig] = None,
        observer_cls: Optional[type] = None,
        genesis_mtx: Optional[Dict[int, tuple]] = None,
    ):
        if n_honest < 1:
            raise ValueError("need at least one honest role")
        self.n_honest = n_honest
        self.n_forkers = n_forkers
        self.events_budget = events
        self.seed = seed
        self.withhold = withhold
        self.node_cls = node_cls or Node
        # ground-truth observer for the union replay: vanilla by default;
        # dynamic-membership worlds pass DynamicNode so the observer
        # interprets membership transactions the way honest nodes do
        # (NEVER the mutated class — the observer is the reference)
        self.observer_cls = observer_cls or Node
        # genesis-carried membership transactions, carrier member index ->
        # ("restake", member, stake) | ("leave", member) | ("join", stake);
        # riding the geneses keeps them in every exploration branch's
        # history, so the transition memo stays sound
        self.genesis_mtx = dict(genesis_mtx or {})
        n_members = n_honest + n_forkers
        self.config = config or SwirldConfig(n_members=n_members, seed=seed)
        if self.config.n_members != n_members:
            raise ValueError("config.n_members != n_honest + n_forkers")
        self.keys: List[Tuple[bytes, bytes]] = [
            crypto.keypair(b"mc-member-%d-%d" % (seed, i))
            for i in range(n_members)
        ]
        self.members: List[bytes] = [pk for pk, _sk in self.keys]
        self.byz_members = frozenset(self.members[n_honest:])
        # role table: honest roles first (role index == member index),
        # then two branch roles per forker
        self.roles: List[Role] = [
            Role("honest", i, -1) for i in range(n_honest)
        ]
        for k in range(n_forkers):
            self.roles.append(Role("branch", n_honest + k, 0))
            self.roles.append(Role("branch", n_honest + k, 1))
        self.honest_roles = list(range(n_honest))
        self.branch_roles = list(range(n_honest, len(self.roles)))
        # global append-only event table; idempotent across exploration
        # branches (equal mints hash to equal ids)
        self.events: Dict[bytes, Event] = {}
        self._geneses: List[bytes] = []
        for i in range(n_members):
            pk, sk = self.keys[i]
            g = Event(
                d=self._genesis_payload(i), p=(), t=0, c=pk
            ).signed(sk)
            self.events[g.id] = g
            self._geneses.append(g.id)
        self._cache: "OrderedDict[Tuple[int, tuple], Node]" = OrderedDict()
        self._union_cache: "OrderedDict[tuple, Node]" = OrderedDict()
        # transition memo: an action's outcome (batch, trace) is a pure
        # function of the actor's and server's local histories (plus the
        # branch tip for branch actors) — global states sharing those
        # locals share the transition, so re-executions are table hits
        self._tmemo: Dict[tuple, Tuple[tuple, tuple]] = {}

    def _genesis_payload(self, i: int) -> bytes:
        spec = self.genesis_mtx.get(i)
        if spec is None:
            return b""
        from tpu_swirld_torch.membership import txs as mtx

        kind = spec[0]
        if kind == "restake":
            return mtx.restake_payload(
                self.members[int(spec[1])], int(spec[2])
            )
        if kind == "leave":
            return mtx.leave_payload(self.members[int(spec[1])])
        if kind == "join":
            jpk, _sk = crypto.keypair(
                b"mc-joiner-%d-%d" % (self.seed, i)
            )
            return mtx.join_payload(jpk, int(spec[1]))
        raise ValueError(f"unknown genesis_mtx kind {kind!r}")

    # ------------------------------------------------------------- state

    def initial_state(self) -> MCState:
        histories = tuple(
            (self._geneses[role.member],) for role in self.roles
        )
        heads = tuple(
            self._geneses[self.roles[q].member] for q in self.branch_roles
        )
        return MCState(histories=histories, heads=heads, created=0)

    def budget_left(self, state: MCState) -> int:
        return self.events_budget - state.created

    def head_of(self, state: MCState, branch_role: int) -> bytes:
        return state.heads[branch_role - self.n_honest]

    # ----------------------------------------------------------- actions

    def enabled_actions(self, state: MCState) -> List[tuple]:
        acts: List[tuple] = []
        budget = self.budget_left(state) > 0
        views = [frozenset(h) for h in state.histories]
        for i in self.honest_roles:
            for j, role in enumerate(self.roles):
                if j == i or role.member == i:
                    continue
                # a pull from a server whose view we already contain is
                # a guaranteed no-op (reliable transport, honest serve):
                # prune it here instead of paying the transition
                if not views[j] <= views[i]:
                    acts.append(("pull", i, j))
                if budget:
                    acts.append(("sync", i, j))
        if budget:
            for b in self.branch_roles:
                for j in self.honest_roles:
                    acts.append(("ext", b, j))
                if self.withhold and self._stale_parent(state, b) is not None:
                    acts.append(("wext", b))
        return acts

    def hunt_weight(self, state: MCState, action: tuple) -> float:
        """Sampling weight for the random-walk hunt: creations beat
        pulls, denser sources beat sparse ones (gossip ladders build
        rounds), and branch extensions rotate toward the branch that
        has minted least (fork pairs need both siblings to move)."""
        kind = action[0]
        if kind == "pull":
            return 1.0
        if kind == "sync":
            return 2.0 * len(state.histories[action[2]])
        # ext / wext: count the branch's own mints (history entries by
        # its own member beyond the genesis)
        b = action[1]
        own_pk = self.members[self.roles[b].member]
        own = sum(
            1 for eid in state.histories[b] if self.events[eid].c == own_pk
        ) - 1
        return 6.0 / (1.0 + own)

    @staticmethod
    def action_writes_reads(action: tuple) -> Tuple[frozenset, frozenset]:
        """(writes, reads) role sets — the POR independence footprint."""
        kind = action[0]
        if kind in ("pull", "sync", "ext"):
            return frozenset((action[1],)), frozenset((action[2],))
        return frozenset((action[1],)), frozenset()       # wext

    @classmethod
    def independent(cls, a: tuple, b: tuple) -> bool:
        """Actions commute iff neither writes what the other touches.
        (The shared event budget also commutes: both orders decrement it
        identically, and co-enabledness is symmetric in it.)"""
        wa, ra = cls.action_writes_reads(a)
        wb, rb = cls.action_writes_reads(b)
        return not (wa & (wb | rb)) and not (wb & (wa | ra))

    # ------------------------------------------------------ materialize

    def materialize(self, role_index: int, history: tuple) -> Node:
        """Fresh node replaying ``history`` through the real code path.

        Honest roles run one ``consensus_pass`` per arrival (the
        checker's delivery granularity); branch nodes only store
        (mirroring ``DivergentForker`` — branches never decide)."""
        role = self.roles[role_index]
        pk, sk = self.keys[role.member]
        cls = self.node_cls if role.kind == "honest" else Node
        node = cls(
            sk=sk, pk=pk, network={}, members=self.members,
            config=self.config, create_genesis=False, network_want={},
        )
        honest = role.kind == "honest"
        for eid in history:
            if node.add_event(self.events[eid]) and honest:
                node.consensus_pass([eid])
        return node

    def node_for(self, role_index: int, history: tuple) -> Node:
        """Cached read-only node for ``(role, history)`` — the serving
        side of pulls, invariant evaluation, and the clone source for
        actors.  Never mutate a node returned from here."""
        key = (role_index, history)
        node = self._cache.get(key)
        if node is None:
            node = self.materialize(role_index, history)
            self._cache[key] = node
            if len(self._cache) > _CACHE_CAP:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        return node

    def _fresh_actor(self, role_index: int, history: tuple) -> Node:
        """Mutable clone of the cached node — exploration steps clones,
        never cached originals."""
        return self._clone_node(self.node_for(role_index, history))

    @staticmethod
    def _clone_node(src: Node) -> Node:
        """Structure-aware clone, ~20x cheaper than ``copy.deepcopy``:
        immutable leaves (Events, keys, config, members) are shared,
        every mutable container is copied at its actual nesting depth,
        and the per-node machinery (transport over the clone's own
        network dicts, breaker, lamport clock binding, jitter rng) is
        rebuilt against the clone.  Covers ``Node`` and the attribute-
        free mutation subclasses; the counterexample replay equality
        test pins clone/replay equivalence."""
        dst = object.__new__(type(src))
        nd = dst.__dict__
        for k, v in src.__dict__.items():
            t = type(v)
            if t is dict:
                nd[k] = dict(v)
            elif t is list:
                nd[k] = list(v)
            elif t is set:
                nd[k] = set(v)
            else:
                nd[k] = v
        # containers nested deeper than one level (a shallow dict copy
        # would alias the inner lists/sets/dicts)
        for k in ("member_events", "member_chain", "wit_list"):
            nd[k] = {a: list(b) for a, b in src.__dict__[k].items()}
        nd["branch_tips"] = {a: set(b) for a, b in src.branch_tips.items()}
        for k in ("by_seq", "fork_groups", "witnesses"):
            nd[k] = {
                a: {s: list(g) for s, g in inner.items()}
                for a, inner in src.__dict__[k].items()
            }
        # the port's DynamicNode keeps per-witness seq bounds of its
        # members' chains; two clones may hold different branches of a
        # forker's chain, so each takes its own copy
        if "_bounds" in nd:
            nd["_bounds"] = {
                w: (dict(below), dict(above))
                for w, (below, above) in src._bounds.items()
            }
        # per-clone identity
        nd["network"] = {}
        nd["network_want"] = {}
        nd["transport"] = Transport(nd["network"], nd["network_want"])
        if src._clock == src._lamport_clock:
            nd["_clock"] = dst._lamport_clock
        br = src.breaker
        if br is not None:
            nb = object.__new__(type(br))
            nb.__dict__.update(br.__dict__)
            nb._failures = dict(br._failures)
            nb._misbehavior = dict(br._misbehavior)
            nb._opened_at = dict(br._opened_at)
            nb._probing = set(br._probing)
            nb._clock = nd["_clock"]
            nd["breaker"] = nb
        rng = random.Random(0)   # state overwritten from the source rng
        rng.setstate(src._retry_rng.getstate())
        nd["_retry_rng"] = rng
        return dst

    def union_observer(self, state: MCState) -> Node:
        """Fresh-observer union replay over the honest stores (the
        chaos harness's ``oracle_order`` ground truth): canonical
        ``(t, id)`` toposort of the union, one batch, one pass."""
        views = tuple(sorted(
            set().union(*(state.view(i) for i in self.honest_roles))
        ))
        node = self._union_cache.get(views)
        if node is None:
            ordered = toposort(
                sorted(views, key=lambda e: (self.events[e].t, e)),
                lambda e: [p for p in self.events[e].p],
            )
            pk, sk = self.keys[0]
            node = self.observer_cls(
                sk=sk, pk=pk, network={}, members=self.members,
                config=self.config, create_genesis=False, network_want={},
            )
            new_ids = [
                eid for eid in ordered
                if node.add_event(self.events[eid])
            ]
            node.consensus_pass(new_ids)
            self._union_cache[views] = node
            if len(self._union_cache) > _CACHE_CAP:
                self._union_cache.popitem(last=False)
        return node

    # ----------------------------------------------------------- execute

    def _stale_parent(self, state: MCState, branch_role: int) -> Optional[bytes]:
        """Deterministic maximally-stale other-parent for ``wext``: the
        EARLIEST event of the lowest-indexed other member in the branch's
        view (arrival order; first arrival of a member is its genesis)."""
        role = self.roles[branch_role]
        own_pk = self.members[role.member]
        firsts: Dict[bytes, bytes] = {}
        for eid in state.view(branch_role):
            c = self.events[eid].c
            if c != own_pk and c not in firsts:
                firsts[c] = eid
        for m in self.members:
            if m in firsts:
                return firsts[m]
        return None

    def _wire(self, actor: Node, server: Node) -> List[Tuple[int, int, str]]:
        """Point the actor's network dicts at the server and install the
        transport step-hook recorder."""
        actor.network[server.pk] = server.ask_sync
        actor.network_want[server.pk] = server.ask_events
        trace: List[Tuple[int, int, str]] = []
        mi = {m: i for i, m in enumerate(self.members)}
        actor.transport.on_call = lambda src, dst, chan: trace.append(
            (mi[src], mi[dst], chan)
        )
        return trace

    @staticmethod
    def _unwire(actor: Node) -> None:
        actor.network.clear()
        actor.network_want.clear()
        actor.transport.on_call = None

    def transition_key(self, state: MCState, action: tuple) -> tuple:
        """Hashable identity of a transition: everything its outcome is
        a function of.  Also the dedup key for per-edge invariant
        checks — equal keys imply identical parent/child node pairs."""
        ai = action[1]
        key = [action, state.histories[ai]]
        if action[0] in ("pull", "sync", "ext"):
            key.append(state.histories[action[2]])
        if self.roles[ai].kind == "branch":
            key.append(self.head_of(state, ai))
        return tuple(key)

    def _successor(self, state: MCState, action: tuple,
                   batch: Tuple[bytes, ...]) -> MCState:
        kind = action[0]
        ai = action[1]
        histories = list(state.histories)
        histories[ai] = histories[ai] + batch
        heads = state.heads
        created = state.created
        if kind in ("sync", "ext", "wext"):
            created += 1
        if kind in ("ext", "wext"):
            heads = list(heads)
            heads[ai - self.n_honest] = batch[-1]
            heads = tuple(heads)
        return MCState(
            histories=tuple(histories), heads=heads, created=created,
        )

    def apply(self, state: MCState, action: tuple,
              actor: Optional[Node] = None,
              server: Optional[Node] = None,
              cache_child: bool = True) -> ActionResult:
        """Execute ``action`` from ``state``; returns the successor.

        ``actor`` must be a MUTABLE node for the acting role (a live
        node in schedule replay; cloned from the cache when omitted);
        ``server`` may be a cached node — the happy-path serve is
        read-only.  The returned batch is exactly what the actor
        ingested+created, in order — appending it to the actor's history
        reproduces the actor bit-for-bit."""
        kind = action[0]
        ai = action[1]
        role = self.roles[ai]
        own_actor = actor is None
        tkey = None
        if own_actor:
            tkey = self.transition_key(state, action)
            memo = self._tmemo.get(tkey)
            if memo is not None:
                batch, trace = memo
                if not batch:
                    return ActionResult(state, batch, True, ai, trace)
                return ActionResult(
                    self._successor(state, action, batch),
                    batch, False, ai, trace,
                )
            actor = self._fresh_actor(ai, state.histories[ai])
        trace: Tuple[Tuple[int, int, str], ...] = ()
        if kind in ("pull", "sync", "ext"):
            j = action[2]
            if server is None:
                server = self.node_for(j, state.histories[j])
            tr = self._wire(actor, server)
            src_pk = server.pk
            if kind == "pull":
                new_ids = actor.pull(src_pk)
                if role.kind == "honest":
                    for eid in new_ids:
                        actor.consensus_pass([eid])
                batch = tuple(new_ids)
            elif kind == "sync":
                new_ids = actor.sync(src_pk, b"")
                for eid in new_ids:
                    actor.consensus_pass([eid])
                batch = tuple(new_ids)
            else:                                   # ext
                pulled = actor.pull(src_pk)
                op = (
                    actor.member_events[src_pk][-1]
                    if actor.member_events[src_pk] else None
                )
                batch = tuple(pulled)
                if op is not None:
                    batch += (self._mint_branch_event(state, ai, actor, op),)
            if own_actor:
                self._unwire(actor)
            trace = tuple(tr)
        elif kind == "wext":
            op = self._stale_parent(state, ai)
            batch = ()
            if op is not None and op in actor.hg:
                batch = (self._mint_branch_event(state, ai, actor, op),)
        else:
            raise ValueError(f"unknown action {action!r}")
        noop = not batch
        if tkey is not None:
            self._tmemo[tkey] = (batch, trace)
        if noop:
            return ActionResult(state, batch, True, ai, trace)
        for eid in batch:
            # register freshly-minted events (sync creates inside the
            # node) in the global table; identical re-creations on other
            # exploration branches dedupe by id
            if eid not in self.events:
                self.events[eid] = actor.hg[eid]
        new_state = self._successor(state, action, batch)
        if own_actor and cache_child:
            key = (ai, new_state.histories[ai])
            if key not in self._cache:
                self._cache[key] = actor
                if len(self._cache) > _CACHE_CAP:
                    self._cache.popitem(last=False)
        return ActionResult(new_state, batch, False, ai, trace)

    def _mint_branch_event(
        self, state: MCState, branch_role: int, actor: Node, op: bytes
    ) -> bytes:
        """Extend a fork branch: self-parent is the RECORDED branch tip
        (never ``actor.head`` — sibling-branch events learned through
        honest gossip must not move this branch's own tip), timestamp is
        ``max(parent timestamps) + 1`` (a pure function of the parents),
        payload tags the branch so sibling branches mint distinct events
        at equal seq — the fork pair."""
        role = self.roles[branch_role]
        pk, sk = self.keys[role.member]
        sp = self.head_of(state, branch_role)
        ev = Event(
            d=b"mc-branch:%d" % role.branch,
            p=(sp, op),
            t=max(self.events[sp].t, self.events[op].t) + 1,
            c=pk,
        ).signed(sk)
        self.events.setdefault(ev.id, ev)
        actor.add_event(ev)
        return ev.id

    # --------------------------------------------------- live schedules

    def run_schedule(
        self,
        schedule: List[tuple],
        on_step: Optional[Callable[[int, MCState, ActionResult, Node, Node], None]] = None,
    ) -> Dict[int, Node]:
        """Faithful live execution of an explicit schedule (the
        counterexample replay path): one persistent node per role,
        mutated in place — byte-identical to the exploration semantics
        because materialization IS replay of these same arrivals.

        ``on_step(step, state_after, result, parent_actor, actor)`` is
        invoked after each non-noop action (parent_actor is the acting
        node's state *before* the step, freshly materialized for edge
        invariants).  Returns the final role -> Node map.
        """
        state = self.initial_state()
        nodes: Dict[int, Node] = {
            r: self.materialize(r, state.histories[r])
            for r in range(len(self.roles))
        }
        for step, action in enumerate(schedule):
            ai = action[1]
            parent_hist = state.histories[ai]
            server = None
            if action[0] in ("pull", "sync", "ext"):
                server = nodes[action[2]]
            res = self.apply(state, action, actor=nodes[ai], server=server)
            self._unwire(nodes[ai])
            if res.noop:
                continue
            if on_step is not None:
                parent_actor = self.node_for(ai, parent_hist)
                on_step(step, res.state, res, parent_actor, nodes[ai])
            state = res.state
        return nodes
