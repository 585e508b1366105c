"""Leader election over the bus: lease + fencing tokens (a copy of
``koordinator_tpu/client/leaderelection.py``).

Reference: every koordinator binary is leader-elected through a
client-go resource lock before its loops start
(cmd/koord-scheduler/app/server.go:226-252 LeaderCallbacks,
cmd/koord-manager/main.go:123-126 LeaderElection options). The HTTP
lease machinery reduces, on the in-process bus, to a Lease object whose
acquisition is an atomic read-modify-write under the store lock
(``APIServer.transact``).

Two deliberate strengthenings over the reference (which inherits
client-go's known weakness that a paused leader can still write after
losing the lease):

- every change of holder increments a **fencing token**; components
  route leader-gated bus mutations through :meth:`LeaderElector.fenced`
  which re-validates holder+token under the store lock, so a deposed
  leader's in-flight writes raise :class:`FencingError` instead of
  double-applying;
- time is injected (``now`` parameters) so failover is deterministic
  under test — no wall-clock sleeps.

The callback shape mirrors the reference: ``on_started_leading`` /
``on_stopped_leading``; losing the lease is fatal for the loop that was
gated on it (the reference exits the process; run loops here stop).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from koordinator_tpu_torch.client.bus import APIServer, Kind


class FencingError(RuntimeError):
    """A leader-gated write carried a stale fencing token (the writer
    lost the lease between deciding and applying)."""


@dataclasses.dataclass
class Lease:
    """The coordination object (reference: coordination/v1 Lease as used
    by client-go resourcelock)."""

    holder: str
    acquire_time: float
    renew_time: float
    duration_seconds: float
    #: monotonic across holder changes — the fencing token
    token: int = 0

    def expired(self, now: float) -> bool:
        return now >= self.renew_time + self.duration_seconds


#: reference defaults (client-go leaderelection.LeaderElectionConfig)
LEASE_DURATION = 15.0
RENEW_DEADLINE = 10.0
RETRY_PERIOD = 2.0


class LeaderElector:
    """Acquire/renew loop for one identity on one lease.

    Drive with :meth:`tick` (idempotent, safe at any cadence; production
    loops call it every ``retry_period``). Like client-go, a deposed
    leader may still observe ``is_leader() == True`` until its next tick
    (the zombie window between losing the lease and noticing) —
    ``is_leader`` is advisory. The HARD guarantee is :meth:`fenced`: at
    most one identity's fenced writes succeed per lease token, checked
    under the store lock, so a zombie's write raises :class:`FencingError`
    instead of double-applying.
    """

    def __init__(
        self,
        bus: APIServer,
        lease_name: str,
        identity: str,
        lease_duration: float = LEASE_DURATION,
        renew_deadline: float = RENEW_DEADLINE,
        retry_period: float = RETRY_PERIOD,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        self.bus = bus
        self.lease_name = lease_name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leading = False
        self._token: Optional[int] = None
        self._last_renew: Optional[float] = None

    # -- state ---------------------------------------------------------------

    def is_leader(self) -> bool:
        return self._leading

    @property
    def token(self) -> Optional[int]:
        """The fencing token of the currently held lease (None while
        standby)."""
        return self._token

    # -- the election step ---------------------------------------------------

    def tick(self, now: float) -> bool:
        """One acquire-or-renew step; returns ``is_leader()`` after."""
        if self._leading:
            self._renew(now)
        else:
            self._try_acquire(now)
        return self._leading

    def _try_acquire(self, now: float) -> None:
        def txn():
            lease = self.bus.get(Kind.LEASE, self.lease_name)
            if lease is not None and not lease.expired(now) \
                    and lease.holder != self.identity:
                return None  # held by a live peer
            token = 1 if lease is None else (
                lease.token if lease.holder == self.identity
                else lease.token + 1
            )
            new = Lease(
                holder=self.identity,
                acquire_time=now,
                renew_time=now,
                duration_seconds=self.lease_duration,
                token=token,
            )
            self.bus.apply(Kind.LEASE, self.lease_name, new)
            return new

        got = self.bus.transact(txn)
        if got is not None:
            self._leading = True
            self._token = got.token
            self._last_renew = now
            if self.on_started_leading:
                self.on_started_leading()

    def _renew(self, now: float) -> None:
        def txn():
            lease = self.bus.get(Kind.LEASE, self.lease_name)
            if lease is None or lease.holder != self.identity \
                    or lease.token != self._token:
                return False  # deposed: someone re-acquired
            self.bus.apply(Kind.LEASE, self.lease_name, dataclasses.replace(
                lease, renew_time=now,
            ))
            return True

        last = self._last_renew if self._last_renew is not None else now
        if now - last > self.renew_deadline:
            # could not renew within the deadline: give up leadership
            # even if the lease object still names us (clock-skew safety,
            # mirrors client-go's renew-deadline semantics)
            self._demote()
            return
        if self.bus.transact(txn):
            self._last_renew = now
        else:
            self._demote()

    def _demote(self) -> None:
        self._leading = False
        self._token = None
        self._last_renew = None
        if self.on_stopped_leading:
            self.on_stopped_leading()

    # -- fenced writes -------------------------------------------------------

    def fenced(self, fn: Callable[[], object]) -> object:
        """Run a bus mutation only if this elector STILL holds the lease
        (checked under the store lock). Raises :class:`FencingError`
        otherwise — the caller's round aborts instead of double-applying
        a deposed leader's decision."""
        token = self._token

        def txn():
            lease = self.bus.get(Kind.LEASE, self.lease_name)
            if (
                token is None
                or lease is None
                or lease.holder != self.identity
                or lease.token != token
            ):
                raise FencingError(
                    f"{self.identity} lost lease {self.lease_name!r}"
                )
            return fn()

        return self.bus.transact(txn)

    def release(self) -> None:
        """Voluntarily step down (graceful shutdown): expire the lease in
        place so a standby can take over without waiting out the
        duration. The lease object is KEPT (holder cleared, token
        preserved) — deleting it would reset the token sequence to 1 and
        let a later holder reuse an old token, breaking the fencing
        tokens' monotonicity that external consumers order by."""
        def txn():
            lease = self.bus.get(Kind.LEASE, self.lease_name)
            if lease is not None and lease.holder == self.identity \
                    and lease.token == self._token:
                self.bus.apply(Kind.LEASE, self.lease_name, dataclasses.replace(
                    lease, holder="", renew_time=float("-inf"),
                ))

        if self._leading:
            self.bus.transact(txn)
            self._demote()
