"""Parent-side health plane: scrape the exporters into one cluster doc
(``repro/obs/health.py``).

``cluster_health(cluster, dealer=None)`` polls every party daemon's
``/metrics.json`` endpoint (plus the dealer's, when one is attached) and
evaluates liveness and progress probes into a single JSON-clean health
document -- the thing ``serve_over_sockets(metrics=True)`` puts in its
report and ``ClusterSGD.health()`` returns between steps.  The
document's shape is the JAX package's, so its gate script reads the
port's documents too.

Probes (all **age-gated** on the metrics' ``updated`` wall-clock
timestamps so a snapshot taken between rounds never false-fires):

  * ``rank_down`` / ``dealer_down`` -- the process died or its exporter
    did not answer (scrape failure with the process still alive counts:
    a wedged daemon cannot serve its own health);
  * ``round_stall`` -- a rank has a task in flight but its online round
    counter has not advanced for ``stall_s`` seconds: the lock-step mesh
    is stuck (a peer died mid-round, a protocol deadlocked);
  * ``dealer_lag`` -- some rank wants a prep session beyond the dealer's
    watermark and the watermark has not moved for ``stall_s`` seconds
    while the dealer claims to still be dealing;
  * ``bank_low`` -- a rank's live bank ran dry (depth < ``bank_low``)
    and stayed dry for ``stall_s`` seconds mid-task while the dealer is
    still supposed to stream (transient empty banks during healthy
    overlap are normal -- the age gate is what separates them from an
    underrun).

``HealthMonitor`` polls in a background thread during a run (live
training under a dealer, as netbench's ``--live`` block watches it) and
keeps every probe that ever fired, so a transient stall still fails the
gate (``scripts/check_health.py``) even if the final scrape looks clean.
Start it on a warm cluster, after a first task: a task that closes no
online round for ``stall_s`` (a cold first batch on a freshly booted
cluster, or one waiting for its first streamed session) reads as a
``round_stall``.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from .registry import snapshot_updated, snapshot_value

DEFAULT_STALL_S = 5.0
DEFAULT_BANK_LOW = 1


def scrape(port: int, host: str = "127.0.0.1",
           timeout: float = 2.0) -> dict:
    """Fetch one exporter's registry snapshot (``/metrics.json``)."""
    url = f"http://{host}:{port}/metrics.json"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _try_scrape(port, timeout):
    if port is None:
        return None
    try:
        return scrape(port, timeout=timeout)
    except (urllib.error.URLError, OSError, ValueError):
        return None


# ---------------------------------------------------------------------------
# Probe evaluation: pure over plain snapshots (unit-testable offline).
# ---------------------------------------------------------------------------
def evaluate_probes(rank_snaps: dict, dealer_snap: dict | None = None, *,
                    now: float | None = None,
                    stall_s: float = DEFAULT_STALL_S,
                    bank_low: int = DEFAULT_BANK_LOW,
                    dealer_attached: bool = False) -> list:
    """Progress probes over already-scraped snapshots.

    ``rank_snaps`` maps rank -> snapshot (missing/None ranks are handled
    by the liveness check in ``cluster_health``, not here).  Returns a
    list of fired probes ``{"probe", "rank"?, ...detail}``.
    """
    now = time.time() if now is None else now
    probes: list = []
    dealer_done = bool(dealer_snap and snapshot_value(
        dealer_snap, "trident_dealer_done"))

    for rank, snap in sorted(rank_snaps.items()):
        if snap is None:
            continue
        inflight = snapshot_value(snap, "trident_cluster_tasks_inflight")
        if not inflight:
            continue
        # round_stall: mid-task, but no online round closed for stall_s.
        # Fall back to the inflight gauge's own timestamp (task start)
        # for a task that never reached its first round.
        last = snapshot_updated(snap, "trident_wire_round_scopes_total",
                                phase="online")
        if not last:
            last = snapshot_updated(snap, "trident_cluster_tasks_inflight")
        if last and now - last > stall_s:
            probes.append({"probe": "round_stall", "rank": rank,
                           "stalled_s": now - last})
        # bank_low: the live bank stayed dry mid-task while the dealer
        # should still be streaming
        if dealer_attached and not dealer_done:
            depth = snapshot_value(snap, "trident_live_bank_depth",
                                   default=None)
            depth_ts = snapshot_updated(snap, "trident_live_bank_depth")
            if depth is not None and depth < bank_low and depth_ts \
                    and now - depth_ts > stall_s:
                probes.append({"probe": "bank_low", "rank": rank,
                               "depth": depth, "dry_s": now - depth_ts})

    # dealer_lag: a rank wants a session past the watermark, and the
    # watermark has not moved for stall_s while the dealer still deals
    if dealer_snap is not None and not dealer_done:
        wanted = max((snapshot_value(s, "trident_prep_next_session")
                      for s in rank_snaps.values() if s is not None),
                     default=0)
        watermark = snapshot_value(dealer_snap, "trident_dealer_watermark")
        wm_ts = snapshot_updated(dealer_snap, "trident_dealer_watermark")
        if wanted > watermark and wm_ts and now - wm_ts > stall_s:
            probes.append({"probe": "dealer_lag", "wanted": wanted,
                           "watermark": watermark,
                           "stalled_s": now - wm_ts})
    return probes


# ---------------------------------------------------------------------------
# The scraper: one merged health document per poll.
# ---------------------------------------------------------------------------
def cluster_health(cluster, dealer=None, *,
                   stall_s: float = DEFAULT_STALL_S,
                   bank_low: int = DEFAULT_BANK_LOW,
                   timeout: float = 2.0) -> dict:
    """Scrape all four party exporters (plus the dealer's) into one
    health document.  ``cluster`` needs ``alive()`` and ``metrics_ports``
    (``PartyCluster(metrics=True)``); ``dealer`` needs ``metrics_port``
    and the daemon-handle surface (the ``DealerDaemon`` of such a
    cluster)."""
    now = time.time()
    ports = getattr(cluster, "metrics_ports", None) or {}
    alive = cluster.alive()
    doc = {"ts": now, "ranks": {}, "dealer": None, "probes": [],
           "healthy": True}

    rank_snaps: dict = {}
    for rank in sorted(alive):
        snap = _try_scrape(ports.get(rank), timeout)
        rank_snaps[rank] = snap
        entry = {
            "alive": alive[rank],
            "port": ports.get(rank),
            "scrape_ok": snap is not None,
        }
        if snap is not None:
            entry.update({
                "tasks": snapshot_value(snap,
                                        "trident_cluster_tasks_total"),
                "inflight": snapshot_value(
                    snap, "trident_cluster_tasks_inflight"),
                "online_round_scopes": snapshot_value(
                    snap, "trident_wire_round_scopes_total",
                    phase="online"),
                "bank_depth": snapshot_value(
                    snap, "trident_live_bank_depth", default=None),
                "next_session": snapshot_value(
                    snap, "trident_prep_next_session"),
            })
        if not entry["alive"] or not entry["scrape_ok"]:
            doc["probes"].append({"probe": "rank_down", "rank": rank,
                                  "alive": entry["alive"],
                                  "scrape_ok": entry["scrape_ok"]})
        doc["ranks"][rank] = entry

    dealer_snap = None
    if dealer is not None:
        d_alive = dealer.failed is None and not getattr(
            dealer, "_closed", False)
        port = getattr(dealer, "metrics_port", None)
        dealer_snap = _try_scrape(port, timeout)
        # a finished dealer's process exits on purpose; exitcode 0 covers
        # the window where it exited cleanly but the parent's watcher has
        # not folded the final "done" status in yet
        exitcode = getattr(getattr(dealer, "_proc", None), "exitcode", None)
        done = dealer.done or exitcode == 0
        # no port yet == the dealer process is still booting (the port is
        # published before the first session is dealt) -- warming up, not
        # down
        warming = port is None and d_alive and not done
        doc["dealer"] = {
            "alive": d_alive,
            "port": port,
            "scrape_ok": dealer_snap is not None,
            "dealt": dealer.dealt,
            "done": done,
        }
        if dealer_snap is not None:
            doc["dealer"]["watermark"] = snapshot_value(
                dealer_snap, "trident_dealer_watermark")
        if not done and not warming \
                and (not d_alive or dealer_snap is None):
            doc["probes"].append({"probe": "dealer_down",
                                  "alive": d_alive,
                                  "scrape_ok": dealer_snap is not None})

    doc["probes"].extend(evaluate_probes(
        rank_snaps, dealer_snap, now=now, stall_s=stall_s,
        bank_low=bank_low, dealer_attached=dealer is not None))
    doc["healthy"] = not doc["probes"]
    return doc


class HealthMonitor:
    """Poll ``cluster_health`` in a background thread for the span of a
    run; ``stop()`` returns the final doc plus every probe that EVER
    fired (deduplicated by probe and rank, in first-seen order), so a
    transient stall is not lost to the last scrape looking clean."""

    def __init__(self, cluster, dealer=None, interval: float = 0.2,
                 **probe_kw):
        self._cluster = cluster
        self._dealer = dealer
        self._interval = interval
        self._probe_kw = probe_kw
        # stop() can race the poll thread's _record when the join times
        # out, so the accumulation is lock-guarded
        self._rec_lock = threading.Lock()
        self.scrapes = 0
        self.probes_fired_ever: list = []
        self._seen: set = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="health-monitor")
        self._thread.start()

    def _record(self, doc: dict) -> None:
        with self._rec_lock:
            self.scrapes += 1
            for p in doc["probes"]:
                key = (p["probe"], p.get("rank"))
                if key not in self._seen:
                    self._seen.add(key)
                    self.probes_fired_ever.append(p)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self._record(cluster_health(self._cluster, self._dealer,
                                        **self._probe_kw))

    def stop(self) -> dict:
        """Stop polling; returns the final health doc annotated with the
        whole run's probe history (``scrapes``, ``probes_fired_ever``)."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        doc = cluster_health(self._cluster, self._dealer, **self._probe_kw)
        self._record(doc)
        with self._rec_lock:
            doc["scrapes"] = self.scrapes
            doc["probes_fired_ever"] = list(self.probes_fired_ever)
        doc["healthy"] = doc["healthy"] and not doc["probes_fired_ever"]
        return doc
