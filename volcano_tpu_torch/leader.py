"""Leader election over the store — the ConfigMap-lock analogue.

The port's copy of ``volcano_tpu/leader.py``, with the ``Lease`` kind.
Both reference binaries leader-elect through a ConfigMap resource lock
(cmd/controllers/app/server.go:103-125, KB/cmd/kube-batch/app/
server.go:107-138; 15s lease / 10s renew / 5s retry). Here the lock is a
first-class "Lease" object in the store: the holder renews a timestamp,
and any candidate may take over once the lease expires. State lives
entirely in the store, so a restarted process rejoins the election with
nothing but its identity — the same rebuild-from-the-bus property the
reference gets from etcd.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from volcano_tpu_torch.api.objects import Metadata
from volcano_tpu_torch.backoff import Backoff

DEFAULT_LEASE_DURATION = 15.0  # leaseDuration, server.go:115
DEFAULT_RENEW_DEADLINE = 10.0  # renewDeadline (informational)
DEFAULT_RETRY_PERIOD = 5.0     # retryPeriod, server.go:117 (backoff cap)


@dataclass
class Lease:
    meta: Metadata
    holder: str = ""
    renewed_at: float = 0.0
    duration: float = DEFAULT_LEASE_DURATION
    transitions: int = 0


class LeaderElector:
    def __init__(
        self,
        store,
        name: str,
        identity: str,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        clock: Optional[Callable[[], float]] = None,
        backoff: Optional[Backoff] = None,
    ):
        self.store = store
        self.name = name
        self.identity = identity
        self.lease_duration = lease_duration
        self.clock = clock or time.monotonic
        # candidate retry pacing (reference retryPeriod, server.go:117,
        # jittered): a LOST acquisition — create/CAS race, someone else's
        # live lease — backs off before the next store round trip, so N
        # hot standbys don't hammer the lease key in lockstep after every
        # leadership change.  Any successful acquire/renew resets it.
        self.backoff = backoff or Backoff(base=0.1, cap=DEFAULT_RETRY_PERIOD)
        self._retry_at = -float("inf")

    @property
    def _key(self) -> str:
        return f"/{self.name}"

    def try_acquire(self) -> bool:
        """Acquire or renew the lease; returns whether we are the leader.

        Call once per work loop iteration (the reference's renew loop);
        losing candidates call it again next cycle (retryPeriod). All writes
        are atomic — create loses to an existing lease, takeover and renew
        go through compare-and-swap — so two candidates racing over a
        RemoteStore can never both win (the resource-lock property the
        reference gets from the API server's resourceVersion)."""
        from volcano_tpu_torch.store.store import Conflict

        now = self.clock()
        if now < self._retry_at:
            return False  # lost a recent race; still pacing the retry
        lease = self.store.get("Lease", self._key)
        if lease is None:
            lease = Lease(
                meta=Metadata(name=self.name, namespace=""),
                holder=self.identity,
                renewed_at=now,
                duration=self.lease_duration,
            )
            try:
                self.store.create("Lease", lease)
            except KeyError:  # another candidate created it first
                return self._lost(now)
            return self._won()
        rv = lease.meta.resource_version
        if lease.holder == self.identity:
            lease.renewed_at = now
            lease.duration = self.lease_duration
        elif now - lease.renewed_at > lease.duration:
            lease.holder = self.identity
            lease.renewed_at = now
            lease.duration = self.lease_duration  # new holder's window
            lease.transitions += 1
        else:
            return self._lost(now)
        try:
            self.store.update_cas("Lease", lease, rv)
        except (Conflict, KeyError):  # lost the renew/takeover race
            return self._lost(now)
        return self._won()

    def _won(self) -> bool:
        self.backoff.reset()
        self._retry_at = -float("inf")
        return True

    def _lost(self, now: float) -> bool:
        self._retry_at = now + self.backoff.next()
        return False

    def is_leader(self) -> bool:
        lease = self.store.get("Lease", self._key)
        return lease is not None and lease.holder == self.identity

    def release(self) -> None:
        """Voluntary hand-off: expire our own lease immediately."""
        lease = self.store.get("Lease", self._key)
        if lease is not None and lease.holder == self.identity:
            lease.renewed_at = -float("inf")
            self.store.update("Lease", lease)
