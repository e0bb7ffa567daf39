"""Active byzantine adversary library + scenario registry (copy of the
reference's ``tpu_swirld/adversary.py``).

The chaos harness (:mod:`tpu_swirld_torch.chaos`) exercises crash/omission
faults — lossy links, partitions, restarts — but the whitepaper's
guarantees are stated against *active* adversaries: members that fork,
censor, and strategically time their releases, up to the ``n > 3f``
budget.  This module supplies that adversary class as malicious node
drivers riding the existing :class:`~tpu_swirld_torch.transport.Transport`
seam (so byzantine behavior composes with injected network faults), plus
a registry of named scenarios with machine-checked verdicts:

- :class:`EquivocationStorm` — an equivocating member maintaining
  ``n_branches`` live branch views of its own chain (the 2-branch
  :class:`~tpu_swirld_torch.sim.DivergentForker` generalized), minting fork
  pairs at a configurable rate inside a timed attack window and serving
  different branches to different peers.
- :class:`CensorshipRelay` — a relay that answers syncs honestly EXCEPT
  it drops a chosen victim's events from every reply (sync and
  want-list) during the attack window.  The victim's events still reach
  peers through other routes; the relay's selective silence is what the
  honest side's withholding heuristic must flag.
- :class:`DelayedReleaseStraggler` — withholds its OWN events from every
  reply during a hold window while continuing to pull gossip and extend
  its chain, then releases the whole tail at once.  This is
  :func:`~tpu_swirld_torch.sim.make_straggler_event` generalized into a timed
  strategy: held long enough, the released witnesses land below the
  honest nodes' frozen vote horizon and must register as
  ``late_witnesses`` with zero ``horizon_violations``.
- **fork bomb** — coordinated :class:`EquivocationStorm` drivers at
  ``f = (n-1)//3`` creators (must survive: safety + liveness + zero
  budget flags) and at ``f+1`` (must be *flagged* via the nodes'
  ``budget_exhausted`` admission check, never a silent divergence).

Every scenario runs as a :class:`~tpu_swirld_torch.chaos.ChaosScenario` (the
drivers install through ``ChaosScenario.adversaries``) and produces the
standard chaos verdict — honest decided prefixes bit-identical to the
fault-free oracle replay, decided index advancing after the attack
window — extended with a cross-engine parity section (oracle batch
replay + the chosen windowed driver) and an ``adversary`` section with
the detection counters (``equivocations_detected``,
``withholding_suspected``, ``budget_exhausted``).

``SCENARIOS`` maps scenario name -> runner with the uniform signature
``runner(ckpt_dir, seed=None, engine="incremental", metrics=None,
tracer=None, flightrec=None, device="cuda")``; ``device`` is where the
cross-engine replays and the storms' device runs go (``"cuda"`` raises
without a GPU).  ``python -m tpu_swirld_torch.chaos_run`` builds its
command line from this registry, so a newly registered strategy appears in
``--scenario`` and ``--all``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from tpu_swirld_torch import crypto
from tpu_swirld_torch.chaos import (
    ChaosScenario,
    ChaosSimulation,
    _engines_agree,
    run_horizon_storm,
    run_membership_churn,
    run_overflow_storm,
)
from tpu_swirld_torch.event import Event, decode_event, encode_event
from tpu_swirld_torch.oracle.node import Node


def _decode_blob(reply: bytes):
    """Split one of OUR OWN signed reply blobs back into events (the
    driver re-filters and re-signs with its own key, so no verification
    is needed here — the inner node just produced the blob)."""
    blob = reply[: -crypto.SIG_BYTES]
    events = []
    off = 0
    while off < len(blob):
        ev, off = decode_event(blob, off)
        events.append(ev)
    return events


def _sign_blob(events, sk: bytes) -> bytes:
    blob = b"".join(encode_event(ev) for ev in events)
    return blob + crypto.sign(blob, sk, crypto.DOMAIN_SYNC_REPLY)


class _InnerNodeDriver:
    """Shared plumbing: an adversary that fronts one honest inner
    :class:`Node` (same member key) and rewrites its replies."""

    def __init__(self, sim: ChaosSimulation, index: int):
        pk, sk = sim.keys[index]
        self.pk, self.sk = pk, sk
        self.clock = sim.clock           # [turn] — shared logical time
        self.rng = sim.rng
        self.node = Node(
            sk=sk, pk=pk, network=sim.network, members=sim.members,
            config=sim.config, clock=lambda: self.clock[0],
            network_want=sim.network_want, transport=sim.transport,
        )

    def _gossip(self, honest_pks: List[bytes]) -> None:
        """Keep the inner node a live participant: pull one honest peer
        and extend the self-chain (no consensus pass — serving replies
        only needs the store)."""
        peer = honest_pks[self.rng.randrange(len(honest_pks))]
        try:
            self.node.sync(peer, b"adv:%d" % len(self.node.hg))
        except ValueError:
            pass

    # default endpoints: honest passthrough (subclasses filter)
    def ask_sync(self, from_pk: bytes, req: bytes) -> bytes:
        return self.node.ask_sync(from_pk, req)

    def ask_events(self, from_pk: bytes, req: bytes) -> bytes:
        return self.node.ask_events(from_pk, req)


class EquivocationStorm:
    """``n_branches``-way equivocator minting fork pairs at a set rate.

    Each branch is a full honest :class:`Node` sharing the forker's key
    (all branches create the identical deterministic genesis); peers are
    pinned to a branch round-robin on first contact, so different peers
    see different self-chains.  Inside the attack window every
    ``fork_every`` turns each branch pulls real gossip and extends its
    own chain — one fresh fork pair per branch pair per step.  Outside
    the window the storm goes quiet (it still serves its branches; an
    equivocation cannot be un-published).
    """

    def __init__(
        self,
        sim: ChaosSimulation,
        index: int,
        n_branches: int = 2,
        fork_every: int = 1,
        start: int = 0,
        end: Optional[int] = None,
    ):
        pk, sk = sim.keys[index]
        self.pk, self.sk = pk, sk
        self.clock = sim.clock
        self.rng = sim.rng
        self.fork_every = max(1, fork_every)
        self.start = start
        self.end = end
        self.branches = [
            Node(
                sk=sk, pk=pk, network=sim.network, members=sim.members,
                config=sim.config, clock=lambda: self.clock[0],
                network_want=sim.network_want, transport=sim.transport,
            )
            for _ in range(max(2, n_branches))
        ]
        self._heads = [br.head for br in self.branches]
        self._route: Dict[bytes, int] = {}

    def _branch_for(self, peer_pk: bytes) -> Node:
        b = self._route.get(peer_pk)
        if b is None:
            b = len(self._route) % len(self.branches)
            self._route[peer_pk] = b
        return self.branches[b]

    def ask_sync(self, from_pk: bytes, req: bytes) -> bytes:
        return self._branch_for(from_pk).ask_sync(from_pk, req)

    def ask_events(self, from_pk: bytes, req: bytes) -> bytes:
        return self._branch_for(from_pk).ask_events(from_pk, req)

    def step(self, turn: int, honest_pks: List[bytes]) -> None:
        if turn < self.start or (self.end is not None and turn >= self.end):
            return
        if (turn - self.start) % self.fork_every:
            return
        for bi, br in enumerate(self.branches):
            peer = honest_pks[self.rng.randrange(len(honest_pks))]
            try:
                br.pull(peer)
            except ValueError:
                pass
            op = br.member_events[peer][-1] if br.member_events[peer] else None
            if op is None:
                continue
            ev = Event(
                d=b"storm:%d:%d" % (bi, len(br.hg)),
                p=(self._heads[bi], op),
                t=br._now(),
                c=self.pk,
            ).signed(self.sk)
            br.add_event(ev)
            self._heads[bi] = ev.id


class CensorshipRelay(_InnerNodeDriver):
    """Selective withholding: answer every sync honestly, minus the
    victim's events.  Children of censored events still ship, so they
    orphan on the asker; its want-list round-trips come back to us and
    we censor those too — exactly the evidence pattern the honest side's
    ``withholding_suspected`` heuristic convicts on (the child we served
    proves we held the parent we refused)."""

    def __init__(
        self,
        sim: ChaosSimulation,
        index: int,
        victim_index: int,
        start: int = 0,
        end: Optional[int] = None,
    ):
        super().__init__(sim, index)
        self.victim_pk = sim.members[victim_index]
        self.start = start
        self.end = end

    def _censoring(self) -> bool:
        t = self.clock[0]
        return t >= self.start and (self.end is None or t < self.end)

    def _filter(self, reply: bytes) -> bytes:
        kept = [ev for ev in _decode_blob(reply) if ev.c != self.victim_pk]
        return _sign_blob(kept, self.sk)

    def ask_sync(self, from_pk: bytes, req: bytes) -> bytes:
        reply = self.node.ask_sync(from_pk, req)
        return self._filter(reply) if self._censoring() else reply

    def ask_events(self, from_pk: bytes, req: bytes) -> bytes:
        reply = self.node.ask_events(from_pk, req)
        return self._filter(reply) if self._censoring() else reply

    def step(self, turn: int, honest_pks: List[bytes]) -> None:
        self._gossip(honest_pks)


class DelayedReleaseStraggler(_InnerNodeDriver):
    """Timed self-withholding: keep pulling gossip and extending the own
    chain, but serve NONE of the events created inside the hold window —
    then release the whole tail at once.  Held past the honest frozen
    vote horizon, the released witnesses land below the committed
    frontier and must register as ``late_witnesses`` (full DAG citizens,
    decided not-famous by the ordinary vote structure) with zero
    ``horizon_violations`` — the timed generalization of the one-shot
    forged :func:`~tpu_swirld_torch.sim.make_straggler_event`."""

    def __init__(
        self,
        sim: ChaosSimulation,
        index: int,
        hold_from: int = 0,
        release_at: int = 0,
    ):
        super().__init__(sim, index)
        self.hold_from = hold_from
        self.release_at = release_at
        self._visible: Optional[set] = None   # own ids servable while holding

    def _holding(self) -> bool:
        return self._visible is not None

    def _filter_own(self, reply: bytes) -> bytes:
        kept = [
            ev for ev in _decode_blob(reply)
            if ev.c != self.pk or ev.id in self._visible
        ]
        return _sign_blob(kept, self.sk)

    def ask_sync(self, from_pk: bytes, req: bytes) -> bytes:
        reply = self.node.ask_sync(from_pk, req)
        return self._filter_own(reply) if self._holding() else reply

    def ask_events(self, from_pk: bytes, req: bytes) -> bytes:
        reply = self.node.ask_events(from_pk, req)
        return self._filter_own(reply) if self._holding() else reply

    def step(self, turn: int, honest_pks: List[bytes]) -> None:
        if turn == self.hold_from:
            self._visible = set(self.node.member_events[self.pk])
        if turn >= self.release_at:
            self._visible = None
        self._gossip(honest_pks)


# ------------------------------------------------------------- verdicts


def _honest_counters(sim: ChaosSimulation) -> Dict:
    nodes = sim._live_honest()
    return {
        "equivocations_detected": max(
            (n.equivocations_detected for n in nodes), default=0
        ),
        "withholding_suspected": sum(n.withholding_suspected for n in nodes),
        "budget_exhausted": max((n.budget_exhausted for n in nodes), default=0),
        "sync_branches_capped": sum(n.sync_branches_capped for n in nodes),
        "late_witnesses": sum(len(n.late_witnesses) for n in nodes),
        "horizon_violations": sum(n.horizon_violations for n in nodes),
    }


def _with_engines(sim: ChaosSimulation, verdict: Dict, engine) -> Dict:
    """Fold the cross-engine parity section into the verdict: the most
    complete honest node's DAG replayed through the oracle batch pipeline
    AND the chosen windowed driver(s) must be bit-identical to its live
    state (``batch_oracle_parity`` covers the batch engine,
    ``incremental_batch_parity`` the windowed one).  ``engine`` is one
    driver name or a tuple of them — a tuple replays the same post-attack
    DAG through every named driver off one simulation run, which is how
    the test suite gets all-three-engine verdicts per strategy.  The
    replays run on the simulation's device."""
    probe = max(sim._live_honest(), key=lambda n: len(n.hg))
    names = (engine,) if isinstance(engine, str) else tuple(engine)
    rows = [_engines_agree(probe, engine=e, device=sim.device) for e in names]
    verdict["engines"] = rows[0] if len(rows) == 1 else rows
    verdict["ok"] = bool(
        verdict["ok"]
        and all(
            r["batch_oracle_parity"] and r["incremental_batch_parity"]
            for r in rows
        )
    )
    # the parity fold can flip a green run() verdict red: a red verdict
    # must still carry its flight-recorder bundle
    if not verdict["ok"] and not verdict.get("flightrec_dump"):
        verdict["flightrec_dump"] = sim.flightrec_postmortem(verdict)
    return verdict


# ------------------------------------------------------ scenario registry

#: scenario name -> runner(ckpt_dir, seed=None, engine=..., metrics=None,
#: tracer=None, flightrec=None, device="cuda") -> verdict dict.  Insertion
#: order is the display order.
SCENARIOS: Dict[str, Callable] = {}


def register_scenario(name: str):
    def deco(fn: Callable) -> Callable:
        SCENARIOS[name] = fn
        return fn
    return deco


@register_scenario("equivocation_storm")
def run_equivocation_storm(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """One storm forker (within the f=(n-1)//3 budget for n=5) minting
    fork pairs every other turn through a 110-turn window.  Verdict:
    safety + post-attack liveness + the fork detected
    (``equivocations_detected > 0``), never a budget flag."""
    seed = 7 if seed is None else seed
    scenario = ChaosScenario(
        n_nodes=5, n_turns=200, seed=seed,
        adversaries={
            0: lambda sim, i: EquivocationStorm(
                sim, i, n_branches=2, fork_every=2, start=10, end=120
            ),
        },
        attack_end=120,
    )
    sim = ChaosSimulation(
        scenario, ckpt_dir, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    )
    verdict = sim.run()
    adv = _honest_counters(sim)
    adv["strategy"] = "equivocation_storm"
    verdict["adversary"] = adv
    verdict["ok"] = bool(
        verdict["ok"]
        and adv["equivocations_detected"] > 0
        and adv["budget_exhausted"] == 0
    )
    return _with_engines(sim, verdict, engine)


@register_scenario("censorship")
def run_censorship(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """A relay censors member 1's events out of its replies for 100
    turns.  Safety/liveness must hold (the victim's events reach peers
    over other routes) and at least one honest pull must convict the
    relay (``withholding_suspected > 0``)."""
    seed = 3 if seed is None else seed
    scenario = ChaosScenario(
        n_nodes=5, n_turns=200, seed=seed,
        adversaries={
            0: lambda sim, i: CensorshipRelay(
                sim, i, victim_index=1, start=20, end=120
            ),
        },
        attack_end=120,
    )
    sim = ChaosSimulation(
        scenario, ckpt_dir, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    )
    verdict = sim.run()
    adv = _honest_counters(sim)
    adv["strategy"] = "censorship"
    verdict["adversary"] = adv
    verdict["ok"] = bool(verdict["ok"] and adv["withholding_suspected"] > 0)
    return _with_engines(sim, verdict, engine)


@register_scenario("delayed_release")
def run_delayed_release(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """A straggler holds its own events for ~110 turns — long past the
    honest frozen vote horizon — then releases the tail.  The released
    witnesses must land as ``late_witnesses`` (the deterministic expiry
    horizon registers them as full citizens) with zero
    ``horizon_violations``, and every engine must stay bit-identical."""
    seed = 5 if seed is None else seed
    scenario = ChaosScenario(
        n_nodes=5, n_turns=230, seed=seed,
        adversaries={
            0: lambda sim, i: DelayedReleaseStraggler(
                sim, i, hold_from=30, release_at=140
            ),
        },
        attack_end=140,
    )
    sim = ChaosSimulation(
        scenario, ckpt_dir, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    )
    verdict = sim.run()
    adv = _honest_counters(sim)
    adv["strategy"] = "delayed_release"
    verdict["adversary"] = adv
    verdict["ok"] = bool(
        verdict["ok"]
        and adv["late_witnesses"] > 0
        and adv["horizon_violations"] == 0
    )
    return _with_engines(sim, verdict, engine)


def _run_fork_bomb(
    ckpt_dir: str, seed: int, engine: str, n_forkers: int,
    metrics=None, tracer=None, flightrec=None, device="cuda",
):
    n_nodes = 7
    scenario = ChaosScenario(
        n_nodes=n_nodes, n_turns=220, seed=seed,
        adversaries={
            i: (
                lambda sim, idx: EquivocationStorm(
                    sim, idx, n_branches=2, fork_every=1, start=5, end=130
                )
            )
            for i in range(n_forkers)
        },
        attack_end=130,
    )
    sim = ChaosSimulation(
        scenario, ckpt_dir, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    )
    verdict = sim.run()
    adv = _honest_counters(sim)
    adv["n_forkers"] = n_forkers
    adv["f_budget"] = (n_nodes - 1) // 3
    verdict["adversary"] = adv
    return verdict, sim


@register_scenario("fork_bomb")
def run_fork_bomb(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """Coordinated equivocation at exactly f = (n-1)//3 creators (n=7,
    f=2): the protocol's design point.  Honest nodes must survive —
    safety, post-attack liveness, forks detected — with ZERO budget
    flags (the admission check must not cry wolf at the bound)."""
    seed = 2 if seed is None else seed
    verdict, sim = _run_fork_bomb(
        ckpt_dir, seed, engine, n_forkers=2, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    )
    adv = verdict["adversary"]
    adv["strategy"] = "fork_bomb"
    verdict["ok"] = bool(
        verdict["ok"]
        and adv["equivocations_detected"] > 0
        and adv["budget_exhausted"] == 0
    )
    return _with_engines(sim, verdict, engine)


@register_scenario("fork_bomb_overbudget")
def run_fork_bomb_overbudget(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """Coordinated equivocation at f+1 creators — OUTSIDE the n > 3f
    model.  The obligation is detection, not tolerance: every honest
    node that observes the (f+1)-th forked creator must raise its
    ``budget_exhausted`` admission flag, so a divergence (should one
    occur) is never silent.  The verdict's ``ok`` is the flag plus the
    absence of *unflagged* divergence; the safety section still reports
    what actually happened."""
    seed = 2 if seed is None else seed
    verdict, sim = _run_fork_bomb(
        ckpt_dir, seed, engine, n_forkers=3, metrics=metrics, tracer=tracer,
        flightrec=flightrec, device=device,
    )
    adv = verdict["adversary"]
    adv["strategy"] = "fork_bomb_overbudget"
    flagged = adv["budget_exhausted"] > 0
    diverged = not (
        verdict["safety"]["prefix_agree"] and verdict["safety"]["oracle_agree"]
    )
    adv["silent_divergence"] = bool(diverged and not flagged)
    verdict["ok"] = bool(flagged and not adv["silent_divergence"])
    if not verdict["ok"] and not verdict.get("flightrec_dump"):
        verdict["flightrec_dump"] = sim.flightrec_postmortem(verdict)
    return verdict


@register_scenario("horizon_storm")
def _run_horizon_storm(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """Straggler witnesses across a healing partition: late tails must
    land below the committed frontier with cross-engine bit-parity."""
    return run_horizon_storm(
        ckpt_dir, seed=1 if seed is None else seed, metrics=metrics,
        tracer=tracer, engine=engine, flightrec=flightrec, device=device,
    )


@register_scenario("overflow_storm")
def _run_overflow_storm(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """Witness-table self-healing: fork-storm slot doubling and the
    unclamped round-window retry must finish with oracle parity."""
    return run_overflow_storm(
        seed=4 if seed is None else seed, flightrec=flightrec, device=device,
    )


@register_scenario("membership_churn")
def _run_membership_churn(
    ckpt_dir: str, seed: Optional[int] = None, engine: str = "incremental",
    metrics=None, tracer=None, flightrec=None, device="cuda",
) -> Dict:
    """Dynamic membership under attack: an adversary JOINs by decided
    tx, mounts an equivocation storm across the vote-out boundary, and
    is removed by a decided LEAVE — stake zeroed, witness power gone."""
    return run_membership_churn(
        ckpt_dir, seed=11 if seed is None else seed, flightrec=flightrec,
        device=device,
    )
