"""Replica-seat crash-loop quarantine for the serve fleets (copied from ``ray_lightning_tpu/serve/containment.py``).

The port's own copy, unchanged but for this paragraph and the module
paths.

A fleet seat is the *position* a replica occupies, surviving the replica
itself: when a replica dies, its seat records the death and decides how
eagerly the fleet may rebuild into it. A seat whose sliding-window death
count reaches ``flap_threshold`` is **quarantined** — rebuilds into it
follow a :class:`~ray_lightning_tpu_torch.reliability.RetryPolicy` exponential
backoff (deterministic jitter, salted by seat id so seats sharing one
policy de-correlate) instead of the hot build→die→build loop a
deterministic fault otherwise produces via the fleet's catch-up path.

The table is clock-agnostic: the in-process fleet feeds it tick counts,
the process fleet wall-clock seconds — ``flap_window`` and the policy's
delays are in whatever units the owning fleet's ``now()`` speaks.

Recovery is implicit and deterministic: deaths age out of the sliding
window, so a seat whose rebuilt replica survives longer than
``flap_window`` re-enters the next death at attempt 0 (healthy
fast-rebuild). There is no success callback to miss.

Built and consulted only when ``FleetConfig.flap_window`` is set — a
default fleet never constructs a table, keeping it decision-for-decision
identical to the pre-containment fleet.
"""
from __future__ import annotations

from typing import List, Optional

from ray_lightning_tpu_torch.reliability.retry import RetryPolicy


class _Seat:
    """One replica position: its death history and rebuild gate."""

    __slots__ = ("id", "occupant", "deaths", "attempt", "next_build")

    def __init__(self, seat_id: int):
        self.id = seat_id
        self.occupant: Optional[int] = None  # replica id, None = empty
        self.deaths: List[float] = []        # death times inside the window
        self.attempt = 0                     # consecutive quarantine count
        self.next_build = float("-inf")      # earliest rebuild time


class SeatTable:
    """Sliding-window per-seat death counter + backoff-gated rebuilds.

    ``record_death`` returns the seat's ``next_build`` time when the
    death tripped (or extended) a quarantine, ``None`` for a healthy
    fast-rebuild — the fleet uses the distinction to emit its
    ``fleet.quarantine`` event with the exact scheduled rebuild time.
    """

    def __init__(self, flap_window: float, flap_threshold: int,
                 policy: RetryPolicy):
        if flap_window <= 0:
            raise ValueError(f"flap_window must be > 0, got {flap_window}")
        if flap_threshold < 1:
            raise ValueError(
                f"flap_threshold must be >= 1, got {flap_threshold}")
        self.flap_window = flap_window
        self.flap_threshold = flap_threshold
        self.policy = policy
        self._seats: List[_Seat] = []
        self._next_id = 0

    # ------------------------------------------------------------ seats
    def _seat_of(self, replica_id: int) -> Optional[_Seat]:
        for seat in self._seats:
            if seat.occupant == replica_id:
                return seat
        return None

    def occupy(self, replica_id: int, now: float,
               grow: bool = False) -> int:
        """Seat a (re)built replica; returns the seat id (the backoff
        jitter salt). Fills the lowest buildable empty seat; ``grow``
        (initial build / scale-out) appends a fresh seat when none is
        free — new capacity never waits behind a quarantined seat."""
        free = [s for s in self._seats
                if s.occupant is None and s.next_build <= now]
        if free:
            seat = min(free, key=lambda s: s.id)
        elif grow or all(s.occupant is not None for s in self._seats):
            seat = _Seat(self._next_id)
            self._next_id += 1
            self._seats.append(seat)
        else:
            raise RuntimeError(
                "no buildable seat (all empty seats quarantined) — "
                "callers must check allow_build() first")
        seat.occupant = replica_id
        return seat.id

    def vacate(self, replica_id: int) -> None:
        """Clean removal (scale-in drain): the seat retires with its
        replica — a deliberate shrink is not a death."""
        seat = self._seat_of(replica_id)
        if seat is not None:
            self._seats.remove(seat)

    # ----------------------------------------------------------- deaths
    def record_death(self, replica_id: int, now: float) -> Optional[float]:
        """Mark ``replica_id``'s seat dead at ``now``; gate its rebuild.

        Returns the quarantined seat's ``next_build`` time, or ``None``
        when the windowed death count stayed under ``flap_threshold``
        (seat rebuilds immediately, attempt counter reset)."""
        seat = self._seat_of(replica_id)
        if seat is None:
            # a replica the table never seated (pre-containment adopt
            # path, tests poking internals): give it a seat posthumously
            # so its death still counts
            sid = self.occupy(replica_id, now, grow=True)
            seat = next(s for s in self._seats if s.id == sid)
        seat.occupant = None
        cutoff = now - self.flap_window
        seat.deaths = [t for t in seat.deaths if t > cutoff]
        seat.deaths.append(now)
        if len(seat.deaths) >= self.flap_threshold:
            seat.attempt += 1
            seat.next_build = now + self.policy.delay(
                seat.attempt, salt=seat.id)
            return seat.next_build
        seat.attempt = 0
        seat.next_build = now
        return None

    # ------------------------------------------------------------ gates
    def allow_build(self, now: float) -> bool:
        """May the fleet's catch-up/promote path rebuild right now?
        True iff some empty seat's backoff has elapsed (or no seats
        are empty at all — nothing to gate)."""
        empty = [s for s in self._seats if s.occupant is None]
        if not empty:
            return True
        return any(s.next_build <= now for s in empty)

    def gated(self, now: float) -> int:
        """Empty seats still inside their backoff window — the
        ``serve_fleet_quarantined`` gauge."""
        return sum(1 for s in self._seats
                   if s.occupant is None and s.next_build > now)
