"""Random-gossip DAG synthesis (copy of the reference's
``tpu_swirld/sim.py::generate_gossip_dag``).

The RNG call pattern (``random.Random(seed)``, the same ``randrange`` /
``random`` order) and the payloads (``b"tx:%d"`` / ``b"fork:%d"``) are the
reference's, and events are signed with the simulation signer, so a DAG made
here has the same event ids as the reference's under
``tpu_swirld.crypto.set_backend("sim")``.
"""

from __future__ import annotations

import random
from typing import List, Optional

from tpu_swirld_torch import crypto
from tpu_swirld_torch.event import Event


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
    keys = [
        crypto.SIGNER.keypair(b"dag-%d-%d" % (seed, i)) for i in range(n_members)
    ]
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
