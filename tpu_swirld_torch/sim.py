"""In-process gossip simulation and random-gossip DAG synthesis (copy of
the reference's ``tpu_swirld/sim.py``: ``member_keys``, ``Population``,
``build_population``, ``Simulation``, ``make_simulation``, the module-level
``test`` driver and ``generate_gossip_dag``).

Every node lives in one interpreter and gossip goes through a shared dict
of bound ``ask_sync`` / ``ask_events`` endpoints, under a shared logical
clock and a seeded peer choice.  The RNG call pattern, the payloads and the
key derivation are the reference's, so with the same seed and the same
crypto backend (``crypto.set_backend("sim")`` in both packages) a port
simulation and a reference simulation make the same events in the same
order, and reach the same node states.

:func:`attach_obs` wires observability into a node as the reference's
does (``make_simulation(metrics=, tracer=, finality=, flightrec=)``).

Not ported yet (ROADMAP A10): the fork-injecting adversaries, the divergent
forkers, ``make_straggler_event`` and the stream schedules.
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
