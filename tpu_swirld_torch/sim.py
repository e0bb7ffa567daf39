"""In-process gossip simulation and random-gossip DAG synthesis (copy of
the reference's ``tpu_swirld/sim.py``: ``member_keys``, ``Population``,
``build_population``, ``Simulation``, ``make_simulation``, the module-level
``test`` driver, the byzantine simulations, the stream schedules and
``generate_gossip_dag``).

Every node lives in one interpreter and gossip goes through a shared dict
of bound ``ask_sync`` / ``ask_events`` endpoints, under a shared logical
clock and a seeded peer choice.  The RNG call pattern, the payloads and the
key derivation are the reference's, so with the same seed and the same
crypto backend (``crypto.set_backend("sim")`` in both packages) a port
simulation and a reference simulation make the same events in the same
order, and reach the same node states.

:func:`attach_obs` wires observability into a node as the reference's
does (``make_simulation(metrics=, tracer=, finality=, flightrec=)``).

The byzantine members share the population's ``random.Random`` in the
reference's call order: :class:`ForkingAdversary` (consistent-order forks,
:func:`run_with_forkers`) and :class:`DivergentForker` (an equivocator that
serves different branches to different peers,
:func:`run_with_divergent_forkers`).  :func:`make_straggler_event` forges a
lagging member's stale witness; :func:`chunked_ingest_schedule` holds events
back by a few chunks (a straggler arrival schedule for the windowed drivers)
and :func:`stream_gossip_dag` yields :func:`generate_gossip_dag`'s stream in
chunks.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional, Tuple

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.event import Event
from tpu_swirld_torch.metrics import Metrics
from tpu_swirld_torch.oracle.node import Node
from tpu_swirld_torch.transport import Transport


def attach_obs(
    node: Node, metrics=None, tracer=None, finality=None, flightrec=None,
    label: Optional[str] = None,
) -> None:
    """Wire observability into one node.

    ``metrics``: a shared :class:`~tpu_swirld_torch.metrics.Metrics` (all
    nodes aggregate into one registry), ``True`` for a fresh per-node
    ``Metrics()``, or ``None`` to leave it off.  ``tracer``: a
    :class:`~tpu_swirld_torch.obs.Tracer` shared by every node it is given
    to, or ``None``.  ``finality``: ``True`` builds a per-node
    :class:`~tpu_swirld_torch.obs.finality.FinalityTracker` on the node's
    own logical clock (engine ``"oracle"``, registry shared via ``metrics``
    when given), or pass a prebuilt tracker.  ``flightrec``: a shared
    :class:`~tpu_swirld_torch.obs.flightrec.FlightRecorder`; the node's
    ingest digests land in its ring under ``label`` (default: a pk prefix).
    """
    if label is None:
        label = "n-" + node.pk[:4].hex()
    if metrics:            # falsy (None/False) means disabled
        node.metrics = Metrics() if metrics is True else metrics
    if tracer:
        node.tracer = tracer
    if finality:
        if finality is True:
            from tpu_swirld_torch.obs.finality import FinalityTracker

            registry = (
                node.metrics.registry
                if node.metrics is not None else None
            )
            finality = FinalityTracker(
                "oracle", clock=node._clock, registry=registry,
            )
        node.finality = finality
        node.flightrec_label = label
    if flightrec:
        from tpu_swirld_torch.obs.flightrec import wire_node

        wire_node(node, flightrec, label)


def member_keys(n_nodes: int, seed: int = 0) -> List[Tuple[bytes, bytes]]:
    """Deterministic member keypairs for ``(n_nodes, seed)``: the one
    key-derivation rule of :class:`Population`."""
    return [
        crypto.keypair(b"member-%d-%d" % (seed, i)) for i in range(n_nodes)
    ]


@dataclasses.dataclass
class Population:
    """Shared bootstrap of a gossip population: deterministic member keys,
    the endpoint dicts, the logical clock, the transport and the seeded
    RNG."""

    keys: List[Tuple[bytes, bytes]]
    members: List[bytes]
    network: Dict[bytes, Callable]
    network_want: Dict[bytes, Callable]
    clock: List[int]
    transport: Transport
    rng: random.Random


def build_population(
    n_nodes: int,
    seed: int = 0,
    transport_factory: Optional[Callable] = None,
) -> Population:
    """Derive keys and wire the (initially empty) gossip network.

    ``transport_factory(network, network_want, members, clock)`` builds
    the delivery layer; the default is the reliable in-process
    :class:`~tpu_swirld_torch.transport.Transport`.
    """
    rng = random.Random(seed)
    keys = member_keys(n_nodes, seed)
    members = [pk for pk, _ in keys]
    network: Dict[bytes, Callable] = {}
    network_want: Dict[bytes, Callable] = {}
    clock = [0]
    if transport_factory is not None:
        transport = transport_factory(
            network, network_want, members, lambda: clock[0]
        )
    else:
        transport = Transport(network, network_want)
    return Population(
        keys=keys, members=members, network=network,
        network_want=network_want, clock=clock, transport=transport, rng=rng,
    )


@dataclasses.dataclass
class Simulation:
    """A population of in-process nodes plus the shared gossip network."""

    config: SwirldConfig
    nodes: List[Node]
    network: Dict[bytes, Callable]
    rng: random.Random
    clock: List[int]
    transport: Optional[Transport] = None

    @property
    def members(self) -> List[bytes]:
        return [n.pk for n in self.nodes]

    def tick(self) -> int:
        self.clock[0] += 1
        return self.clock[0]

    def step(self, node_i: Optional[int] = None) -> List[bytes]:
        """One gossip turn: a (random) node syncs with a random other peer
        and runs the consensus pass.  Returns the new event ids."""
        if node_i is None:
            node_i = self.rng.randrange(len(self.nodes))
        node = self.nodes[node_i]
        peers = [pk for pk in self.members if pk != node.pk]
        peer = peers[self.rng.randrange(len(peers))]
        payload = b"tx:%d:%d" % (node_i, self.clock[0])
        new_ids = node.sync(peer, payload)
        node.consensus_pass(new_ids)
        return new_ids

    def run(self, n_turns: int) -> None:
        for _ in range(n_turns):
            self.step()

    def run_until_events(self, n_events: int, max_turns: int = 10**7) -> None:
        """Gossip until some node knows >= n_events events."""
        turns = 0
        while max(len(n.hg) for n in self.nodes) < n_events:
            self.step()
            turns += 1
            if turns > max_turns:
                raise RuntimeError("simulation did not reach target events")


def make_simulation(
    n_nodes: int,
    seed: int = 0,
    config: Optional[SwirldConfig] = None,
    metrics=None,
    tracer=None,
    transport_factory: Optional[Callable] = None,
    finality=None,
    flightrec=None,
) -> Simulation:
    """Build keypairs, the shared network dict and ``n_nodes`` nodes.

    ``metrics=`` / ``tracer=`` (see :func:`attach_obs`) wire gossip
    counters and phase spans into every node; one shared ``Metrics``
    aggregates the population's gossip into one registry, ``metrics=True``
    gives each node its own.  ``finality=True`` gives every node its own
    lifecycle tracker on the shared logical clock (merged into the
    ``metrics`` registry when given); ``flightrec=`` shares one
    :class:`~tpu_swirld_torch.obs.flightrec.FlightRecorder` across the
    population (rings keyed ``n0..n{N-1}``).  ``transport_factory(network,
    network_want, members, clock)`` builds the shared delivery layer.

    A ``"tpu"`` node builds its :class:`~tpu_swirld_torch.backend.
    TorchEngine` at its first consensus pass, on the card; set a node's
    ``_tpu_engine`` beforehand to pick another device.
    """
    config = config or SwirldConfig(n_members=n_nodes, seed=seed)
    if config.n_members != n_nodes:
        raise ValueError("config.n_members != n_nodes")
    pop = build_population(n_nodes, seed, transport_factory)
    clock = pop.clock
    nodes: List[Node] = []
    for i, (pk, sk) in enumerate(pop.keys):
        node = Node(
            sk=sk,
            pk=pk,
            network=pop.network,
            members=pop.members,
            config=config,
            clock=lambda: clock[0],
            network_want=pop.network_want,
            transport=pop.transport,
        )
        attach_obs(
            node, metrics, tracer, finality=finality, flightrec=flightrec,
            label=f"n{i}",
        )
        pop.network[pk] = node.ask_sync
        pop.network_want[pk] = node.ask_events
        nodes.append(node)
    sim = Simulation(
        config=config, nodes=nodes, network=pop.network, rng=pop.rng,
        clock=clock, transport=pop.transport,
    )
    # shared logical clock advances every turn so timestamps vary
    orig_step = sim.step

    def step_with_tick(node_i: Optional[int] = None):
        sim.tick()
        return orig_step(node_i)

    sim.step = step_with_tick  # type: ignore[method-assign]
    return sim


def test(n_nodes: int, n_turns: int, seed: int = 0) -> Simulation:
    """The reference's module-level smoke-test driver."""
    sim = make_simulation(n_nodes, seed=seed)
    sim.run(n_turns)
    return sim


class ForkingAdversary:
    """*Consistent-order* fork injection: a forker occasionally creates a
    sibling of its own head (same self-parent) in its own store, whence
    both branches propagate to every peer through the same honest
    ``ask_sync`` path in one arrival order.

    This exercises fork *detection and tolerance* on a DAG every node sees
    identically.  It does NOT create divergent per-peer views — for the
    byzantine equivocation case (different branches served to different
    peers) use :class:`DivergentForker` / :func:`run_with_divergent_forkers`.
    """

    def __init__(self, sim: Simulation, forker_indices: List[int], fork_every: int = 5):
        self.sim = sim
        self.forkers = forker_indices
        self.fork_every = max(1, fork_every)
        self._count = 0

    def maybe_fork(self) -> None:
        """Every ``fork_every`` calls, one forker creates a fork pair."""
        self._count += 1
        if self._count % self.fork_every:
            return
        fi = self.forkers[self._count // self.fork_every % len(self.forkers)]
        node = self.sim.nodes[fi]
        if node.head is None or not node.hg[node.head].p:
            return
        head_ev = node.hg[node.head]
        others = [pk for pk in self.sim.members if pk != node.pk]
        op = None
        for pk in others:
            if node.member_events[pk]:
                op = node.member_events[pk][-1]
                break
        if op is None or op == head_ev.other_parent:
            return
        # a sibling of the current head: same self-parent, different other-parent
        sibling = Event(
            d=b"fork", p=(head_ev.self_parent, op), t=node._now(), c=node.pk
        ).signed(node.sk)
        try:
            node.add_event(sibling)
            node.divide_rounds([sibling.id])
        except (ValueError, AssertionError):
            return


def run_with_forkers(
    n_nodes: int,
    n_forkers: int,
    n_turns: int,
    seed: int = 0,
    fork_every: int = 7,
    metrics=None,
    tracer=None,
    transport_factory: Optional[Callable] = None,
) -> Simulation:
    """Config-4-style run: honest gossip with periodic fork injection.
    ``metrics=`` / ``tracer=`` as in :func:`make_simulation` — fork-pair
    detections land in ``gossip_fork_pairs_detected``.  The adversary
    injects forks into its own store, so fork *propagation* rides
    whatever transport the sim was built with — pass a faulty
    ``transport_factory`` to compose byzantine + network faults."""
    sim = make_simulation(
        n_nodes, seed=seed, metrics=metrics, tracer=tracer,
        transport_factory=transport_factory,
    )
    adversary = ForkingAdversary(sim, list(range(n_forkers)), fork_every)
    for _ in range(n_turns):
        sim.step()
        adversary.maybe_fork()
    return sim


class DivergentForker:
    """A genuinely equivocating byzantine member: it maintains TWO branch
    views of its own chain and serves *different branches to different
    peers* through its public ``ask_sync`` / ``ask_events`` endpoints
    (BASELINE config 4's adversary model).

    Each branch is a full honest :class:`Node` sharing the forker's key;
    peers are pinned to a branch on first contact.  ``step()`` advances
    both branches: each pulls from a random honest peer (receiving real
    gossip) and extends its own self-chain — producing fork pairs at every
    sequence number.  Honest nodes first receive one branch, later learn
    of the other through third parties (orphan + want-list recovery), and
    must detect the fork and converge without crashing.
    """

    def __init__(
        self,
        sk: bytes,
        pk: bytes,
        members: List[bytes],
        network: Dict[bytes, Callable],
        network_want: Dict[bytes, Callable],
        config: SwirldConfig,
        clock: Callable[[], int],
        rng: random.Random,
        transport: Optional[Transport] = None,
    ):
        self.pk = pk
        self.sk = sk
        self.rng = rng
        # the branch nodes ride the same transport as honest members, so
        # byzantine equivocation composes with injected network faults
        # (drops/partitions hit the forker's pulls too)
        self.branches = [
            Node(
                sk=sk, pk=pk, network=network, members=members,
                config=config, clock=clock, network_want=network_want,
                transport=transport,
            )
            for _ in range(2)
        ]
        # both branches created the identical deterministic genesis; track
        # per-branch heads explicitly (ingesting the sibling branch back
        # from honest gossip must not move a branch's own tip)
        self._heads = [br.head for br in self.branches]
        self._route: Dict[bytes, int] = {}

    def _branch_for(self, peer_pk: bytes) -> Node:
        b = self._route.get(peer_pk)
        if b is None:
            b = len(self._route) % 2
            self._route[peer_pk] = b
        return self.branches[b]

    def ask_sync(self, from_pk: bytes, req: bytes) -> bytes:
        return self._branch_for(from_pk).ask_sync(from_pk, req)

    def ask_events(self, from_pk: bytes, req: bytes) -> bytes:
        return self._branch_for(from_pk).ask_events(from_pk, req)

    def step(self, honest_peers: List[bytes]) -> None:
        """Advance both branches: pull real gossip, extend the fork."""
        for bi, br in enumerate(self.branches):
            peer = honest_peers[self.rng.randrange(len(honest_peers))]
            try:
                br.pull(peer)
            except ValueError:
                pass
            op = br.member_events[peer][-1] if br.member_events[peer] else None
            if op is None:
                continue
            ev = Event(
                d=b"branch:%d:%d" % (bi, len(br.hg)),
                p=(self._heads[bi], op),
                t=br._now(),
                c=self.pk,
            ).signed(self.sk)
            br.add_event(ev)
            self._heads[bi] = ev.id


@dataclasses.dataclass
class DivergentSimulation:
    """Honest nodes + equivocating forkers sharing one gossip network."""

    config: SwirldConfig
    nodes: List[Node]                  # honest nodes only
    forkers: List[DivergentForker]
    network: Dict[bytes, Callable]
    rng: random.Random
    clock: List[int]
    members: List[bytes]
    transport: Optional[Transport] = None


def run_with_divergent_forkers(
    n_nodes: int,
    n_forkers: int,
    n_turns: int,
    seed: int = 0,
    fork_every: int = 3,
    node_config: Optional[Callable[[int, SwirldConfig], SwirldConfig]] = None,
    on_turn: Optional[Callable[[int, List[Node]], None]] = None,
    metrics=None,
    tracer=None,
    transport_factory: Optional[Callable] = None,
) -> DivergentSimulation:
    """Config-4 adversary model: ``n_forkers`` equivocating members serving
    divergent branches; honest nodes must stay live and prefix-consistent
    (within the BFT bound ``n > 3f``).

    ``node_config(i, base)`` may override an honest member's config (e.g.
    switch one node to ``backend="tpu"``); ``on_turn(turn, honest_nodes)``
    runs after every gossip turn (checkpoint hooks, assertions, ...).
    ``metrics=`` / ``tracer=`` (see :func:`attach_obs`) instrument the
    *honest* nodes — the adversary's branch nodes stay unobserved.
    ``transport_factory`` as in :func:`make_simulation`: honest nodes AND
    the forkers' branch nodes all route through the one transport, so
    byzantine and network faults compose in one scenario.
    """
    config = SwirldConfig(n_members=n_nodes, seed=seed)
    pop = build_population(n_nodes, seed, transport_factory)
    rng, members, clock = pop.rng, pop.members, pop.clock
    network, network_want, transport = (
        pop.network, pop.network_want, pop.transport
    )
    forkers: List[DivergentForker] = []
    honest: List[Node] = []
    for i, (pk, sk) in enumerate(pop.keys):
        if i < n_forkers:
            f = DivergentForker(
                sk, pk, members, network, network_want, config,
                lambda: clock[0], rng, transport=transport,
            )
            network[pk] = f.ask_sync
            network_want[pk] = f.ask_events
            forkers.append(f)
        else:
            cfg_i = node_config(i, config) if node_config else config
            node = Node(
                sk=sk, pk=pk, network=network, members=members,
                config=cfg_i, clock=lambda: clock[0],
                network_want=network_want, transport=transport,
            )
            attach_obs(node, metrics, tracer)
            network[pk] = node.ask_sync
            network_want[pk] = node.ask_events
            honest.append(node)
    honest_pks = [n.pk for n in honest]
    for turn in range(n_turns):
        clock[0] += 1
        node = honest[rng.randrange(len(honest))]
        peers = [pk for pk in members if pk != node.pk]
        peer = peers[rng.randrange(len(peers))]
        new_ids = node.sync(peer, b"tx:%d" % turn)
        node.consensus_pass(new_ids)
        if turn % fork_every == 0:
            for f in forkers:
                f.step(honest_pks)
        if on_turn is not None:
            on_turn(turn, honest)
    return DivergentSimulation(
        config=config, nodes=honest, forkers=forkers, network=network,
        rng=rng, clock=clock, members=members, transport=transport,
    )


def make_straggler_event(
    node: Node,
    pk: bytes,
    sk: bytes,
    *,
    at_round: int,
    payload: bytes = b"straggler",
) -> Event:
    """Forge the event a lagging member's stale tail produces: an event by
    ``pk`` whose parents sit deep in ``node``'s history, landing as a
    WITNESS at (roughly) ``at_round`` — typically far below the committed
    frontier, i.e. the deterministic-expiry-horizon corner.

    Self-parent: ``pk``'s earliest event with round < ``at_round``;
    other-parent: the earliest event by another member with round exactly
    ``at_round`` (so the new event's round is ``at_round`` + at most one
    promotion, and exceeds the self-parent's round — the witness
    condition).  When ``pk``'s real chain continued past the chosen
    self-parent this is also a fork pair, exactly as an equivocating or
    amnesiac member would produce.  Raises ``ValueError`` when the DAG has
    no suitable parents yet.
    """
    sp = None
    for eid in node.member_events[pk]:
        if node.round[eid] < at_round:
            sp = eid
            break
    if sp is None:
        raise ValueError(f"{pk[:4].hex()} has no event below round {at_round}")
    op = None
    for eid in node.order_added:
        ev = node.hg[eid]
        if ev.c != pk and node.round[eid] == at_round:
            op = eid
            break
    if op is None:
        raise ValueError(f"no other-member event at round {at_round}")
    t = max(node.hg[sp].t, node.hg[op].t) + 1
    return Event(d=payload, p=(sp, op), t=t, c=pk).signed(sk)


def chunked_ingest_schedule(
    events,
    chunk_size: int,
    *,
    delay_prob: float = 0.0,
    max_delay: int = 3,
    seed: int = 0,
):
    """Split a topo-ordered event stream into ingest chunks.

    With ``delay_prob`` > 0, individual events are held back by up to
    ``max_delay`` chunks (children are always pulled along so every chunk
    stays topologically valid) — an orphan-heavy/straggler arrival
    schedule for exercising :class:`tpu_swirld_torch.gpu.incremental.
    IncrementalConsensus` window-exit paths (events referencing old
    parents force its documented full-recompute fallbacks).
    Returns a list of event lists, each in topo order.
    """
    rng = random.Random(seed)
    idx = {ev.id: j for j, ev in enumerate(events)}
    chunk_of = [0] * len(events)
    for j, ev in enumerate(events):
        c = j // chunk_size
        if delay_prob and rng.random() < delay_prob:
            c += rng.randrange(1, max_delay + 1)
        for p in ev.p:
            c = max(c, chunk_of[idx[p]])
        chunk_of[j] = c
    n_chunks = max(chunk_of) + 1 if events else 0
    out: List[List[Event]] = [[] for _ in range(n_chunks)]
    for j, ev in enumerate(events):
        out[chunk_of[j]].append(ev)
    return out


def stream_gossip_dag(
    n_members: int,
    n_events: int,
    chunk: int,
    seed: int = 0,
    stake: Optional[List[int]] = None,
    n_forkers: int = 0,
    fork_prob: float = 0.05,
):
    """Streaming variant of :func:`generate_gossip_dag`: returns
    ``(members, stake, keys, chunks)`` where ``chunks`` is a *generator*
    of topo-ordered event lists of size ``chunk``.

    Identical event stream to :func:`generate_gossip_dag` for the same
    arguments (same RNG call pattern), but host memory stays
    O(members + chunk): only the per-member branch heads are retained, so
    a config-5-shaped feed (256 members / 100k events) never holds the
    full history — the shape ``bench.py --stream`` ingests.
    """
    rng = random.Random(seed)
    keys = [crypto.keypair(b"dag-%d-%d" % (seed, i)) for i in range(n_members)]
    members = [pk for pk, _ in keys]
    stake = list(stake) if stake is not None else [1] * n_members

    def chunks():
        branches: List[List[Event]] = []
        buf: List[Event] = []
        n_done = 0
        t = 0
        for pk, sk in keys:
            t += 1
            ev = Event(d=b"", p=(), t=t, c=pk).signed(sk)
            buf.append(ev)
            branches.append([ev])
        n_total = n_done + len(buf)
        while n_total < n_events:
            ci = rng.randrange(n_members)
            pi = rng.randrange(n_members - 1)
            if pi >= ci:
                pi += 1
            pk, sk = keys[ci]
            other = branches[pi][rng.randrange(len(branches[pi]))]
            bi = rng.randrange(len(branches[ci]))
            head = branches[ci][bi]
            t += 1
            fork_now = (
                ci < n_forkers and head.p and rng.random() < fork_prob
            )
            if fork_now:
                sp = head.p[0]
                ev = Event(
                    d=b"fork:%d" % n_total, p=(sp, other.id), t=t, c=pk
                ).signed(sk)
                branches[ci].append(ev)
            else:
                ev = Event(
                    d=b"tx:%d" % n_total, p=(head.id, other.id), t=t, c=pk
                ).signed(sk)
                branches[ci][bi] = ev
            buf.append(ev)
            n_total += 1
            if len(buf) >= chunk:
                yield buf
                n_done += len(buf)
                buf = []
        if buf:
            yield buf

    return members, stake, keys, chunks()


def generate_gossip_dag(
    n_members: int,
    n_events: int,
    seed: int = 0,
    stake: Optional[List[int]] = None,
    n_forkers: int = 0,
    fork_prob: float = 0.05,
):
    """Synthesize a valid random-gossip DAG: per-member self-chains stitched
    by random cross-member other-parents.  With ``n_forkers`` the first f
    members equivocate: with probability ``fork_prob`` a forker's new event
    is a sibling of its current head (same self-parent, a fork pair).

    Returns ``(members, stake, events, keys)`` with ``events`` in topo
    order and ``keys`` the (pk, sk) pairs.
    """
    rng = random.Random(seed)
    keys = [crypto.keypair(b"dag-%d-%d" % (seed, i)) for i in range(n_members)]
    members = [pk for pk, _ in keys]
    stake = list(stake) if stake is not None else [1] * n_members
    events: List[Event] = []
    branches: List[List[Event]] = []     # per member: branch heads
    t = 0
    for pk, sk in keys:
        t += 1
        ev = Event(d=b"", p=(), t=t, c=pk).signed(sk)
        events.append(ev)
        branches.append([ev])
    while len(events) < n_events:
        ci = rng.randrange(n_members)
        pi = rng.randrange(n_members - 1)
        if pi >= ci:
            pi += 1
        pk, sk = keys[ci]
        other = branches[pi][rng.randrange(len(branches[pi]))]
        bi = rng.randrange(len(branches[ci]))
        head = branches[ci][bi]
        t += 1
        fork_now = (
            ci < n_forkers and head.p and rng.random() < fork_prob
        )
        if fork_now:
            # sibling of the current head: same self-parent, new branch
            sp = head.p[0]
            ev = Event(
                d=b"fork:%d" % len(events), p=(sp, other.id), t=t, c=pk
            ).signed(sk)
            events.append(ev)
            branches[ci].append(ev)
        else:
            ev = Event(
                d=b"tx:%d" % len(events), p=(head.id, other.id), t=t, c=pk
            ).signed(sk)
            events.append(ev)
            branches[ci][bi] = ev
    return members, stake, events, keys
