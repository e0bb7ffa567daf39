"""Canonical state encoding: dedup digests + creator-symmetry reduction.

The port's copy of the reference's ``tpu_swirld/analysis/mc/encode.py``:
the same keys, byte for byte, so both packages count the same states.

Two schedules that leave every role with the same ingest history are the
same state — the *concrete digest* hashes the histories directly (event
ids are already content hashes).  On top of that, honest members with
equal stake are interchangeable: relabeling honest creators by a
permutation maps reachable states to reachable states, violations to
violations.  The *canonical key* is the minimum over all honest-member
permutations of a structural digest in which each event is encoded by
``(permuted creator slot, timestamp, parent codes, payload tag)``
instead of its id, and the honest history slots are permuted to match.
Attacker members keep their identity (they are parameterized separately
by the world), but their events re-encode through the permuted honest
ancestry.

Soundness: invariants are role-symmetric (they quantify over honest
nodes) and enabled actions permute bijectively, so exploring only the
lexicographically-least representative of each orbit covers every
violation up to renaming.  The naive baseline (``symmetry=False``)
uses the concrete digest as the key, which is what the reduction-ratio
report compares against.
"""

from __future__ import annotations

from itertools import permutations
from typing import Dict, List, Tuple

from tpu_swirld_torch import crypto

from tpu_swirld_torch.analysis.mc.world import MCState, World

_SEP = b"\x00"


def _digest(parts: List[bytes]) -> bytes:
    return crypto.hash_bytes(_SEP.join(parts))[:16]


class StateEncoder:
    """Per-world encoder with memoized structural event codes.

    Event codes are memoized per ``(perm, event id)`` — the event table
    is append-only and codes of shared ancestry are reused across the
    whole exploration, so canonicalization stays cheap even with
    ``n_honest!`` permutations in play.
    """

    def __init__(self, world: World, symmetry: bool = True):
        self.world = world
        self._member_index = {m: i for i, m in enumerate(world.members)}
        self._codes: Dict[Tuple[tuple, bytes], bytes] = {}
        self._state_keys: Dict[MCState, Tuple[bytes, bytes]] = {}
        if symmetry and world.n_honest > 1 and self._honest_stakes_equal():
            self.perms: List[tuple] = [
                p + tuple(range(world.n_honest, len(world.members)))
                for p in permutations(range(world.n_honest))
            ]
        else:
            self.perms = [tuple(range(len(world.members)))]

    def _honest_stakes_equal(self) -> bool:
        stakes = self.world.config.stakes()
        honest = {stakes[i] for i in range(self.world.n_honest)}
        return len(honest) == 1

    # ------------------------------------------------------------ codes

    def _code(self, perm: tuple, eid: bytes) -> bytes:
        memo = self._codes
        key = (perm, eid)
        got = memo.get(key)
        if got is not None:
            return got
        # iterative post-order: events reference strictly earlier mints,
        # so the stack is bounded by the table size
        stack = [eid]
        while stack:
            top = stack[-1]
            if (perm, top) in memo:
                stack.pop()
                continue
            ev = self.world.events[top]
            missing = [p for p in ev.p if (perm, p) not in memo]
            if missing:
                stack.extend(missing)
                continue
            stack.pop()
            parts = [
                b"%d" % perm[self._member_index[ev.c]],
                b"%d" % ev.t,
                ev.d,
            ] + [memo[(perm, p)] for p in ev.p]
            memo[(perm, top)] = _digest(parts)
        return memo[key]

    # ------------------------------------------------------------- keys

    def _encode(self, state: MCState, perm: tuple) -> bytes:
        world = self.world
        n_h = world.n_honest
        # honest slots travel with the permutation; branch slots are
        # fixed (forker members are identity under perm) but their
        # contents re-encode through the permuted honest ancestry
        slots: List[bytes] = [b""] * len(world.roles)
        for r, hist in enumerate(state.histories):
            slot = perm[r] if r < n_h else r
            slots[slot] = _digest([self._code(perm, eid) for eid in hist])
        heads = [self._code(perm, h) for h in state.heads]
        return _digest(slots + heads + [b"%d" % state.created])

    def state_keys(self, state: MCState) -> Tuple[bytes, bytes]:
        """(concrete digest, canonical key) in one pass, memoized per
        state — the identity permutation's encoding is the concrete
        digest, the orbit minimum is the canonical key."""
        got = self._state_keys.get(state)
        if got is not None:
            return got
        concrete = self._encode(state, self.perms[0])
        if len(self.perms) == 1:
            keys = (concrete, concrete)
        else:
            keys = (concrete, min(
                [concrete]
                + [self._encode(state, p) for p in self.perms[1:]]
            ))
        self._state_keys[state] = keys
        return keys

    def concrete_digest(self, state: MCState) -> bytes:
        return self.state_keys(state)[0]

    def canonical_key(self, state: MCState) -> bytes:
        return self.state_keys(state)[1]
