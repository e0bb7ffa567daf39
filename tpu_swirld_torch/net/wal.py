"""Durable own-event WAL with torn-tail recovery.

The chaos harness keeps each member's own-event WAL in memory (the
driver owns both sides of the crash).  A real process killed with
``kill -9`` needs the same guarantee on disk: a signer must never lose
its own signing history, or its restart re-signs at an old sequence
number and equivocates against its own lost tip (the amnesia fork the
chaos module docstring describes).

File layout::

    b"SWAL1" | record*
    record   = <B tag> body
    tag 1    = own event (encode_event blob)
    tag 2    = clean-shutdown marker (no body; always the last byte)

Records are appended with flush+fsync *before* the event's id is
gossiped, so anything a peer may have seen from us is durable.  A crash
mid-append leaves a torn tail: :class:`OwnEventWal` recovers by decoding
records until the first one that is truncated, malformed, fails
signature verification, or names a foreign creator — the valid prefix
is kept, the torn bytes are truncated away (counted in
``torn_tail_recovered``), and appending resumes from the cut.  This can
only drop the *last* record(s), which by the write ordering were never
gossiped — so recovery never loses an event a peer could hold against
us.

The clean-shutdown marker drives the flight recorder: a WAL that exists
but does not end in the marker means the previous process died
uncleanly, and the restarted process dumps a post-mortem at startup
(:func:`tpu_swirld_torch.net.node_proc.startup_postmortem`).  Re-opening for
append truncates the marker away, so a WAL is only ever "clean" between
a graceful stop and the next start.
"""

from __future__ import annotations

import os
from typing import List, Optional

from tpu_swirld_torch.event import (
    Event, MalformedEvent, decode_event, encode_event,
)

MAGIC = b"SWAL1"
TAG_EVENT = 1
TAG_CLEAN = 2


class OwnEventWal:
    """Append-only durable log of one member's self-signed events.

    Args:
      path: WAL file (created with just the magic if absent).
      pk: the owning member's public key; records naming any other
        creator are treated as corruption (the WAL holds *own* events
        only, so a foreign creator can only mean torn/overwritten bytes).

    Attributes:
      events: the recovered valid prefix, in append order.
      existed: the file predated this open (a restart, not a cold start).
      clean_shutdown: the recovered tail carried the clean marker.
      torn_tail_recovered: 1 if a torn/corrupt tail was truncated away.
    """

    def __init__(self, path: str, pk: Optional[bytes] = None):
        self.path = path
        self.pk = pk
        self.events: List[Event] = []
        self.existed = os.path.exists(path)
        self.clean_shutdown = False
        self.torn_tail_recovered = 0
        valid_end = len(MAGIC)
        bad_magic = False
        if self.existed:
            with open(path, "rb") as f:
                data = f.read()
            if data[:len(MAGIC)] != MAGIC:
                # foreign or totally mangled file: everything is tail,
                # including the header — rewrite from scratch
                self.torn_tail_recovered = 1
                bad_magic = True
            else:
                valid_end = self._scan(data)
        # (re)write from the valid prefix: a torn tail (or a stale clean
        # marker) is truncated away so appends resume from sound bytes
        mode = "r+b" if (self.existed and not bad_magic) else "wb"
        self._f = open(path, mode)
        if mode == "wb":
            self._f.write(MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        else:
            self._f.seek(valid_end)
            self._f.truncate(valid_end)

    def _scan(self, data: bytes) -> int:
        """Decode records; returns the byte offset of the valid prefix
        end (the clean marker, when present, is NOT part of the prefix —
        reopening consumes it)."""
        off = len(MAGIC)
        while off < len(data):
            tag = data[off]
            if tag == TAG_CLEAN:
                # a marker anywhere but the final byte means the file
                # was appended to after a "clean" close — torn state
                if off + 1 == len(data):
                    self.clean_shutdown = True
                else:
                    self.torn_tail_recovered = 1
                return off
            if tag != TAG_EVENT:
                self.torn_tail_recovered = 1
                return off
            try:
                ev, nxt = decode_event(data, off + 1)
            except MalformedEvent:
                self.torn_tail_recovered = 1
                return off
            if not ev.verify() or (self.pk is not None and ev.c != self.pk):
                # decodes but does not verify: corrupt-not-truncated
                # tail (bit rot / partial overwrite), same recovery
                self.torn_tail_recovered = 1
                return off
            self.events.append(ev)
            off = nxt
        return off

    @property
    def unclean(self) -> bool:
        """The previous process died without a graceful stop."""
        return self.existed and not self.clean_shutdown

    def append(self, ev: Event) -> None:
        """Durably log one own event (flush + fsync **before** the
        caller gossips it — the ordering the recovery proof needs)."""
        self._f.write(bytes([TAG_EVENT]) + encode_event(ev))
        self._f.flush()
        os.fsync(self._f.fileno())
        self.events.append(ev)

    def rewrite(self, events: List[Event]) -> None:
        """Atomically replace the log (checkpoint pruning: entries the
        checkpoint already covers are dropped, tmp + ``os.replace`` so a
        crash mid-prune leaves either the old or the new file whole)."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC + b"".join(
                bytes([TAG_EVENT]) + encode_event(ev) for ev in events
            ))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "r+b")
        self._f.seek(0, os.SEEK_END)
        self.events = list(events)

    def mark_clean(self) -> None:
        """Graceful-stop marker; the WAL is closed afterwards."""
        self._f.write(bytes([TAG_CLEAN]))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()
