"""Gossip simulations with dynamic membership (a copy of the reference's
``tpu_swirld/membership/sim.py``: at the same seed and schedule, under the
same crypto backend, the same keys, events and node states).

Mirrors :mod:`tpu_swirld_torch.sim` (same key derivation, same shared-clock
population bootstrap) but builds :class:`DynamicNode` populations and
adds the two schedule shapes the membership suites need:

- :func:`make_dynamic_simulation` — a population of dynamic nodes with a
  per-turn payload hook, so membership transactions ride ordinary gossip
  events at scripted turns;
- :func:`churn_schedule` — a canonical multi-epoch event schedule (a
  leave then a join, decided rounds apart → ≥2 epoch transitions) plus
  the genesis member/stake vectors, for the cross-engine parity and
  bench/soak harnesses.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Optional

from tpu_swirld_torch import crypto
from tpu_swirld_torch.config import SwirldConfig
from tpu_swirld_torch.membership.dynamic import DynamicNode, joining_node
from tpu_swirld_torch.membership.txs import join_payload, leave_payload
from tpu_swirld_torch.sim import build_population, member_keys


@dataclasses.dataclass
class DynamicSimulation:
    """A population of :class:`DynamicNode` plus the shared network."""

    config: SwirldConfig
    nodes: List[DynamicNode]
    network: Dict[bytes, Callable]
    network_want: Dict[bytes, Callable]
    rng: random.Random
    clock: List[int]
    #: turn -> payload to ride the syncing node's next event (consumed)
    tx_schedule: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    turn: int = 0

    @property
    def members(self) -> List[bytes]:
        return [n.pk for n in self.nodes]

    def step(self, node_i: Optional[int] = None) -> List[bytes]:
        self.clock[0] += 1
        t = self.turn
        self.turn += 1
        if node_i is None:
            node_i = self.rng.randrange(len(self.nodes))
        node = self.nodes[node_i]
        peers = [n.pk for n in self.nodes if n.pk != node.pk]
        if not peers:
            return []
        peer = peers[self.rng.randrange(len(peers))]
        payload = self.tx_schedule.pop(t, b"")
        new_ids = node.sync(peer, payload)
        node.consensus_pass(new_ids)
        return new_ids

    def run(self, n_turns: int) -> None:
        for _ in range(n_turns):
            self.step()

    def add_joiner(self, sk: bytes, pk: bytes) -> DynamicNode:
        """Bring a not-yet-decided member online: it self-admits for
        gossip and participates; stake arrives when its JOIN decides."""
        jn = joining_node(
            sk, pk, self.network, list(self.members), self.config,
            clock=lambda: self.clock[0], network_want=self.network_want,
        )
        self.network[pk] = jn.ask_sync
        self.network_want[pk] = jn.ask_events
        self.nodes.append(jn)
        return jn


def make_dynamic_simulation(
    n_nodes: int,
    seed: int = 0,
    config: Optional[SwirldConfig] = None,
    tx_schedule: Optional[Dict[int, bytes]] = None,
) -> DynamicSimulation:
    """Same population bootstrap as :func:`tpu_swirld_torch.sim.make_simulation`
    (identical keys for a given seed) with :class:`DynamicNode` members."""
    config = config or SwirldConfig(n_members=n_nodes, seed=seed)
    if config.n_members != n_nodes:
        raise ValueError("config.n_members != n_nodes")
    pop = build_population(n_nodes, seed)
    nodes: List[DynamicNode] = []
    for pk, sk in pop.keys:
        node = DynamicNode(
            sk=sk, pk=pk, network=pop.network, members=pop.members,
            config=config, clock=lambda: pop.clock[0],
            network_want=pop.network_want,
        )
        pop.network[pk] = node.ask_sync
        pop.network_want[pk] = node.ask_events
        nodes.append(node)
    return DynamicSimulation(
        config=config, nodes=nodes, network=pop.network,
        network_want=pop.network_want, rng=pop.rng, clock=pop.clock,
        tx_schedule=dict(tx_schedule or {}),
    )


def churn_schedule(
    n_nodes: int = 4,
    seed: int = 0,
    turns: int = 700,
    leave_at: int = 30,
    join_at: int = 260,
    join_stake: int = 2,
    config: Optional[SwirldConfig] = None,
):
    """A canonical multi-epoch schedule: member ``n-1`` leaves, then a
    fresh key joins, turns apart so the two transactions decide in
    different rounds (≥ 2 epoch transitions).

    Returns ``(events, members, stake, sim)`` where ``events`` is node
    0's DAG in insertion (topo) order — the input shape
    :func:`tpu_swirld_torch.membership.engine.run_dynamic` consumes — and
    ``sim`` is the finished simulation for further inspection.
    """
    config = config or SwirldConfig(n_members=n_nodes, seed=seed)
    jpk, jsk = crypto.keypair(b"churn-joiner-%d" % seed)
    sim = make_dynamic_simulation(
        n_nodes, seed=seed, config=config,
        tx_schedule={
            leave_at: leave_payload(sim_member(n_nodes, seed, n_nodes - 1)),
            join_at: join_payload(jpk, join_stake),
        },
    )
    sim.run(turns)
    node = sim.nodes[0]
    events = [node.hg[e] for e in node.order_added]
    stake = list(node._genesis_stake)
    return events, list(node._genesis_members), stake, sim


def sim_member(n_nodes: int, seed: int, i: int) -> bytes:
    """The i-th member pk for ``(n_nodes, seed)`` (sim key derivation)."""
    return member_keys(n_nodes, seed)[i][0]
