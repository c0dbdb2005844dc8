"""Generic circuit breaker (the port's copy of `spectre_tpu/utils/breaker.py`,
where it was extracted from the beacon client).

The beacon client's breaker: N consecutive
failures trip it OPEN (calls fail fast for a cooldown), then HALF-OPEN
admits exactly one trial request — success closes it, failure re-opens
it for another cooldown. The proof-farm dispatcher needs the identical
machinery per prover replica, so the state machine lives here once and
both layers parameterize it with their own counter prefix:

* ``beacon_breaker_trips`` / ``beacon_breaker_half_open`` (BeaconClient)
* ``dispatcher_breaker_trips`` / ``dispatcher_breaker_half_open``
  (prover_service/dispatcher.py, one breaker per replica)

Counters ride :data:`~spectre_tpu_torch.utils.health.HEALTH`, so they surface
in ``/healthz`` and as ``spectre_*_total`` in ``/metrics`` with zero
exporter changes. ``clock`` is injectable for deterministic tests.
"""

from __future__ import annotations

import time

from .health import HEALTH

# numeric codes for the Prometheus exporter (a gauge can't carry a
# string; alerting rules compare against these)
STATE_CODES = {"closed": 0, "half-open": 1, "open": 2}


class BreakerOpen(RuntimeError):
    """Failing fast: the breaker is open (downstream considered down)."""


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open trial admission.

    State is derived, never stored: ``opened_at is None`` means closed;
    an ``opened_at`` older than ``cooldown`` means half-open (one trial
    admitted); anything younger means open. ``record(ok)`` feeds it.
    """

    def __init__(self, threshold: int = 5, cooldown: float = 30.0,
                 health=HEALTH, counter_prefix: str = "breaker",
                 clock=time.time):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.health = health
        self.counter_prefix = counter_prefix
        self._clock = clock
        self.consecutive_failures = 0
        self.opened_at: float | None = None
        self._half_open = False

    @property
    def state(self) -> str:
        if self.opened_at is None:
            return "closed"
        if self._clock() - self.opened_at >= self.cooldown:
            return "half-open"
        return "open"

    @property
    def state_code(self) -> int:
        return STATE_CODES.get(self.state, -1)

    def remaining(self) -> float:
        """Seconds of cooldown left (0 when not open)."""
        if self.opened_at is None:
            return 0.0
        return max(0.0, self.cooldown - (self._clock() - self.opened_at))

    def admit(self):
        """Gate one call: raises :class:`BreakerOpen` while open; the
        first admission after the cooldown marks the half-open trial
        (counted on ``<prefix>_half_open``)."""
        state = self.state
        if state == "open":
            raise BreakerOpen(
                f"circuit breaker open for another {self.remaining():.1f}s "
                f"after {self.consecutive_failures} consecutive failures")
        if state == "half-open" and not self._half_open:
            self._half_open = True
            self.health.incr(f"{self.counter_prefix}_half_open")

    def record(self, ok: bool):
        """Feed one call outcome. A success closes the breaker; a failed
        half-open trial (or hitting the threshold) re-opens it for a full
        cooldown and counts a trip on ``<prefix>_trips``."""
        if ok:
            self.consecutive_failures = 0
            self.opened_at = None
            self._half_open = False
            return
        self.consecutive_failures += 1
        half_open_failed = self._half_open
        self._half_open = False
        if (half_open_failed
                or self.consecutive_failures >= self.threshold):
            if self.opened_at is None or half_open_failed:
                self.health.incr(f"{self.counter_prefix}_trips")
            self.opened_at = self._clock()

    def snapshot(self) -> dict:
        return {"state": self.state, "state_code": self.state_code,
                "consecutive_failures": self.consecutive_failures}
