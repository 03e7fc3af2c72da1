"""Shard-following ingress client: the live side of the 421 contract.

Port of the JAX package's ``serving/ingress_client.py``. The serving
plane refuses a wrong shard: a ``/predict`` for a user whose partition
another worker owns answers ``421 Misdirected Request`` with the owner's
identity and address, before admission (a
wrong-shard request must not burn QoS tokens). What was missing is the
client that actually closes the loop — the reference's ingress/load
balancer role (arXiv:2109.09541 §4: dumb clients + deterministic
routing). :class:`ShardIngressClient` is that client:

- **follows 421s**: a misdirected request is re-issued once to the
  ``location`` the owning worker advertised (bounded by
  ``max_redirects`` — two workers with momentarily divergent membership
  views can bounce a key, and the client must not ping-pong forever);
- **learns affinity**: the user→worker mapping from every success and
  every 421 lands in a bounded local cache, so steady-state traffic goes
  direct and the 421 path is only paid on membership changes — exactly
  the rebalance-cost model of the consistent-hash ring;
- **retries outages deterministically**: a connection-refused /
  dropped-socket worker (mid-rebalance restart, a kill) is retried with
  ``DeterministicBackoff`` while rotating to the next known worker —
  bounded, jittered, replayable through the injected sleep seam.

No new protocol: plain HTTP against ``serving/app.py``'s existing
surface; the client works against any subset of the fleet's base URLs.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Mapping, Optional, Sequence

__all__ = ["ShardIngressClient", "NoShardAvailableError"]


class NoShardAvailableError(ConnectionError):
    """Every known worker refused or was unreachable within the retry
    budget — the fleet (or the network to it) is down from this
    client's seat."""


class ShardIngressClient:
    """HTTP ``/predict`` client that follows wrong-shard redirects."""

    AFFINITY_CAP = 100_000        # bounded user->URL cache

    def __init__(self, workers: Mapping[str, str] | Sequence[str],
                 timeout_s: float = 10.0, max_redirects: int = 3,
                 retries: int = 4, retry_sleep=None):
        from realtime_fraud_detection_tpu_torch.utils.backoff import (
            DeterministicBackoff,
            instance_seed,
        )

        if isinstance(workers, Mapping):
            self.urls = [u.rstrip("/") for u in workers.values()]
        else:
            self.urls = [str(u).rstrip("/") for u in workers]
        if not self.urls:
            raise ValueError("ShardIngressClient needs >= 1 worker URL")
        self.timeout_s = float(timeout_s)
        self.max_redirects = max(0, int(max_redirects))
        self.retries = max(0, int(retries))
        self.backoff = DeterministicBackoff(
            base_s=0.05, mult=2.0, max_s=1.0,
            seed=instance_seed(";".join(sorted(self.urls))),
            sleep=retry_sleep)
        self._rr = 0
        self._affinity: Dict[str, str] = {}
        self.requests = 0
        self.redirects_followed = 0
        self.retried = 0
        self.affinity_hits = 0

    # ---------------------------------------------------------------- http
    def _post(self, url: str, payload: Mapping[str, Any]) -> tuple:
        """(status, body) — 421 surfaces as a value, not an exception."""
        req = urllib.request.Request(
            url + "/predict", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            body: Any = {}
            try:
                body = json.loads(e.read() or b"{}")
            except (ValueError, OSError):
                pass
            return e.code, body

    def _next_url(self) -> str:
        url = self.urls[self._rr % len(self.urls)]
        self._rr += 1
        return url

    def _remember(self, user_id: str, url: str) -> None:
        if user_id and url:
            if len(self._affinity) >= self.AFFINITY_CAP:
                self._affinity.clear()        # rare, O(1) amortized
            self._affinity[user_id] = url

    # ------------------------------------------------------------- predict
    def predict(self, txn: Mapping[str, Any]) -> Dict[str, Any]:
        """Score one transaction on whichever worker owns its user.

        Tries the learned-affinity URL first (steady state: zero 421s),
        follows up to ``max_redirects`` wrong-shard redirects, and on
        connection failure backs off deterministically while rotating to
        the next known worker. Raises :class:`NoShardAvailableError`
        when the whole budget is exhausted; any non-421 HTTP status is
        returned to the caller inside the body (the serving plane's own
        error contract — sheds are 200s, validation failures 422s)."""
        uid = str(txn.get("user_id", ""))
        url = self._affinity.get(uid)
        if url is not None:
            self.affinity_hits += 1
        else:
            url = self._next_url()
        self.requests += 1
        attempt = 0
        redirects = 0
        last_err: Optional[Exception] = None
        while True:
            try:
                status, body = self._post(url, txn)
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last_err = e
                self._affinity.pop(uid, None)
                if attempt >= self.retries:
                    raise NoShardAvailableError(
                        f"no worker reachable for user {uid!r} after "
                        f"{attempt} retries: {last_err}") from e
                self.backoff.sleep(attempt)
                attempt += 1
                self.retried += 1
                url = self._next_url()
                continue
            if status == 421:
                # a 421 is PROOF the asked worker does not own this user
                # — invalidate any learned affinity pointing there FIRST,
                # even when the redirect cannot be followed: mid-
                # rebalance, a previously-confirmed mapping is exactly
                # the entry most likely to be stale, and keeping it
                # would re-route every later request for this user into
                # the same refusal
                if self._affinity.get(uid) == url:
                    self._affinity.pop(uid, None)
                location = str((body or {}).get("location") or "")
                if not location or redirects >= self.max_redirects:
                    # bounded-redirect guard: two workers with divergent
                    # membership views can bounce a key back and forth —
                    # terminate with an explicit error, never a loop
                    raise NoShardAvailableError(
                        f"wrong shard for user {uid!r} and no followable "
                        f"location after {redirects} redirects "
                        f"(owner={body.get('owner')!r})")
                redirects += 1
                self.redirects_followed += 1
                url = location.rstrip("/")
                self._remember(uid, url)
                continue
            self._remember(uid, url)
            if isinstance(body, dict):
                body["_ingress"] = {"worker_url": url, "status": status,
                                    "redirects": redirects}
            return body

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Any]:
        return {
            "workers": list(self.urls),
            "requests": self.requests,
            "redirects_followed": self.redirects_followed,
            "retried": self.retried,
            "affinity_hits": self.affinity_hits,
            "affinity_size": len(self._affinity),
        }
