"""Live HTTP signal clients: Prometheus-compatible, OpenCost, carbon API.

The PyTorch form of `ccka_tpu/signals/live.py`: the clients are host
code and the same; :class:`LiveSignalSource` hands its traces out as
float32 tensors on the device the caller names.

The reference's live query path is PromQL over the AMP query API through a
SigV4 proxy — e.g. ``/api/v1/label/__name__/values`` and
``/api/v1/query?query=up`` (`demo_40_watch_observe.sh:106-110`), the same
endpoint OpenCost is pointed at as an "external Prometheus"
(`06_opencost.sh:404-429`). The carbon API is stubbed with an empty key and a
dummy fallback (`.env:14-16`).

These clients speak those same wire formats. Transport is injectable (any
``fetch(url, headers) -> bytes``) so tests run on canned JSON and a live
deployment can wrap SigV4 signing or bearer auth without changing parsing.
Every client degrades gracefully to its configured default when the endpoint
is unreachable — the reference's dummy-carbon behavior, generalized.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Mapping

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import (ClusterConfig, SignalsConfig, SimConfig,
                                   WorkloadConfig)
from ccka_tpu_torch.signals.base import (ExogenousTrace, SignalSource,
                                         TraceMeta, as_f32)
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

Fetch = Callable[[str, Mapping[str, str]], bytes]


def _default_fetch(timeout_s: float) -> Fetch:
    def fetch(url: str, headers: Mapping[str, str]) -> bytes:
        req = urllib.request.Request(url, headers=dict(headers))
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:  # noqa: S310
            return resp.read()
    return fetch


def default_fetch(timeout_s: float) -> Fetch:
    """Public alias of the module's urllib transport — the fetch the
    concurrent scrape fan-in (`signals/transport.py`) pools per tenant.
    Kept as a separate name so the private one can keep evolving with
    the retry stack without committing its signature."""
    return _default_fetch(timeout_s)


class RetryingFetch:
    """Jittered exponential-backoff retry around any ``fetch`` transport.

    One-shot fetches meant a transient 500/flaky LB wasted the whole
    control tick (the scrape falls back to the synthetic prior for 30s
    of real decisions). This wrapper retries transport-level failures
    (``OSError``/``TimeoutError`` — ``urllib.error.URLError`` is an
    OSError; malformed-body errors are NOT retried, they are the
    server's answer) with full-jitter exponential backoff:
    ``backoff_s * 2^attempt * U(0.5, 1.5)``. The retry budget is
    bounded by ``deadline_s`` (the tick's ``request_timeout_s``): sleeps
    never push past it and no NEW attempt starts once it is spent —
    each in-flight attempt is additionally bounded by the transport's
    own socket timeout, so one call takes at most ``deadline_s`` plus
    one transport timeout. When the budget is spent the LAST error is
    re-raised — callers (the per-family try/excepts in
    :class:`LiveSignalSource`) then mark the tick ``stale`` and fall
    back, feeding the controller's degraded-mode path instead of
    raising mid-controller.

    ``sleep``/``rand`` are injectable for tests (and ``rand`` defaults
    to a private PRNG so retry jitter never perturbs global
    ``random``)."""

    def __init__(self, fetch: Fetch, *, retries: int = 2,
                 backoff_s: float = 0.4, deadline_s: float = 10.0,
                 sleep=None, rand=None, clock=None):
        import random as _random
        import time as _time

        self.fetch = fetch
        self.retries = max(0, int(retries))
        self.backoff_s = backoff_s
        self.deadline_s = deadline_s
        self.sleep = sleep if sleep is not None else _time.sleep
        self.rand = rand if rand is not None else _random.Random(0x5e7)
        self.clock = clock if clock is not None else _time.monotonic

    def __call__(self, url: str, headers: Mapping[str, str]) -> bytes:
        t0 = self.clock()
        last: BaseException | None = None
        for attempt in range(self.retries + 1):
            try:
                return self.fetch(url, headers)
            except (OSError, TimeoutError) as e:
                last = e
            if attempt >= self.retries:
                break
            delay = (self.backoff_s * (2 ** attempt)
                     * (0.5 + self.rand.random()))
            remaining = self.deadline_s - (self.clock() - t0)
            if remaining <= 0.0:
                break  # budget spent — don't blow the tick deadline
            self.sleep(min(delay, remaining))
            if self.clock() - t0 >= self.deadline_s:
                break  # deadline hit mid-sleep — no new attempt
        assert last is not None
        raise last


class SignalUnavailable(RuntimeError):
    """A live endpoint could not be reached or returned malformed data."""


class PrometheusClient:
    """Minimal Prometheus HTTP API client (instant + range queries).

    Query path shape matches the reference's smoke queries against the AMP
    SigV4 proxy (`demo_40_watch_observe.sh:106-110`):
    ``{base}/api/v1/query?query=...`` and ``/api/v1/query_range``.
    """

    def __init__(self, base_url: str, *, fetch: Fetch | None = None,
                 timeout_s: float = 10.0, headers: Mapping[str, str] | None = None):
        self.base_url = base_url.rstrip("/")
        self.fetch = fetch or _default_fetch(timeout_s)
        self.headers = dict(headers or {})

    def _get(self, path: str, params: Mapping[str, str]) -> dict:
        url = f"{self.base_url}{path}?{urllib.parse.urlencode(params)}"
        try:
            raw = self.fetch(url, self.headers)
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise SignalUnavailable(f"prometheus fetch failed: {url}: {e}") from e
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError as e:
            raise SignalUnavailable(f"prometheus returned non-JSON: {url}") from e
        if doc.get("status") != "success":
            raise SignalUnavailable(f"prometheus error response: {doc.get('error')}")
        return doc["data"]

    def query(self, promql: str) -> list[tuple[dict, float]]:
        """Instant query → list of (metric labels, value)."""
        data = self._get("/api/v1/query", {"query": promql})
        out = []
        for series in data.get("result", []):
            ts_val = series.get("value")
            if ts_val is None:
                continue
            out.append((series.get("metric", {}), float(ts_val[1])))
        return out

    def query_range(self, promql: str, start: float, end: float,
                    step_s: float) -> list[tuple[dict, np.ndarray, np.ndarray]]:
        """Range query → list of (labels, times[T], values[T])."""
        data = self._get("/api/v1/query_range", {
            "query": promql, "start": str(start), "end": str(end),
            "step": f"{step_s}s",
        })
        out = []
        for series in data.get("result", []):
            pts = series.get("values", [])
            times = np.array([float(t) for t, _ in pts])
            vals = np.array([float(v) for _, v in pts])
            out.append((series.get("metric", {}), times, vals))
        return out

    def label_values(self, label: str) -> list[str]:
        """`/api/v1/label/<name>/values` — the reference's first smoke query
        (`demo_40_watch_observe.sh:108`)."""
        data = self._get(f"/api/v1/label/{label}/values", {})
        return list(data) if isinstance(data, list) else list(data.get("result", []))


class OpenCostClient:
    """OpenCost allocation/cost API client (`06_opencost.sh:430-437`).

    Exposes per-namespace/pod cost and node pricing; endpoint shape follows
    OpenCost's ``/allocation`` and ``/assets`` APIs on :9090 (the UI/API port
    the reference port-forwards, `demo_40_watch_observe.sh:60-68`).
    """

    def __init__(self, base_url: str, *, fetch: Fetch | None = None,
                 timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.fetch = fetch or _default_fetch(timeout_s)

    def _get(self, path: str, params: Mapping[str, str]) -> dict:
        url = f"{self.base_url}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        try:
            raw = self.fetch(url, {})
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise SignalUnavailable(f"opencost fetch failed: {url}: {e}") from e
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise SignalUnavailable(f"opencost returned non-JSON: {url}") from e

    def allocation(self, window: str = "1h",
                   aggregate: str = "namespace") -> dict[str, float]:
        """Total cost per aggregate over the window → {name: $}."""
        doc = self._get("/allocation", {"window": window, "aggregate": aggregate})
        out: dict[str, float] = {}
        for bucket in doc.get("data", []) or []:
            if not bucket:
                continue
            for name, alloc in bucket.items():
                out[name] = out.get(name, 0.0) + float(alloc.get("totalCost", 0.0))
        return out

    def node_prices_hr(self) -> dict[str, float]:
        """Per-node $/hr from the assets API → {node_name: $/hr}."""
        doc = self._get("/assets", {"window": "1h", "filterCategories": "Compute"})
        out: dict[str, float] = {}
        data = doc.get("data", {})
        items = data.items() if isinstance(data, dict) else []
        for name, asset in items:
            hourly = asset.get("hourlyCost") if isinstance(asset, dict) else None
            if hourly is not None:
                out[name] = float(hourly)
        return out


class SLOMetricsClient:
    """App-level SLO metrics: p95 latency, RPS, queue depth.

    The reference *advertises* these as the autoscaler's SLO inputs
    (`README.md:21` "latency SLOs", proposal PDF p.1) yet its pipeline
    scrapes only kube-state-metrics (`06_opencost.sh:324-327`) — no app
    latency, request-rate or queue metric is ever collected (§2.3). This
    client issues the standard PromQL for all three against the same
    Prometheus-compatible endpoint, degrading to ``None`` per metric when
    series are absent (a cluster without app instrumentation), so callers
    can log gaps instead of fabricating numbers.
    """

    def __init__(self, prom: PrometheusClient,
                 namespace: str = "nov-22"):
        self.prom = prom
        self.namespace = namespace

    def _scalar(self, promql: str) -> float | None:
        try:
            rows = self.prom.query(promql)
        except SignalUnavailable:
            return None
        if not rows:
            return None
        val = rows[0][1]
        return None if val != val else val  # NaN → absent histogram

    def latency_p95_s(self) -> float | None:
        """p95 request latency over 5m, histogram-quantile form."""
        return self._scalar(
            "histogram_quantile(0.95, sum(rate("
            f'http_request_duration_seconds_bucket{{namespace="{self.namespace}"}}'
            "[5m])) by (le))")

    def rps(self) -> float | None:
        """Served request rate over 5m."""
        return self._scalar(
            f'sum(rate(http_requests_total{{namespace="{self.namespace}"}}[5m]))')

    def queue_depth(self) -> float | None:
        """Scheduler queue depth: Pending pods in the workload namespace —
        the series the burst observer tabulates
        (`demo_30_burst_observe.sh:20-28`)."""
        return self._scalar(
            'sum(kube_pod_status_phase{phase="Pending",'
            f'namespace="{self.namespace}"}})')

    def snapshot(self) -> dict[str, float]:
        """All available metrics (absent ones omitted), ms-normalized."""
        out: dict[str, float] = {}
        p95 = self.latency_p95_s()
        if p95 is not None:
            out["latency_p95_ms"] = p95 * 1000.0
        rps = self.rps()
        if rps is not None:
            out["rps"] = rps
        q = self.queue_depth()
        if q is not None:
            out["queue_depth"] = q
        return out


class CarbonIntensityClient:
    """ElectricityMaps-style carbon intensity client.

    Implements the capability the reference stubbed: `.env:14-16` holds an
    empty ``CARBON_API_KEY``, a zone (`US-CAL-CISO`), and a comment promising
    a dummy ~400 g/kWh fallback; a `07_carbonexporter.sh` was named as future
    work (report PDF p.2). With no key or an unreachable endpoint this client
    returns the configured default, exactly as documented there.
    """

    def __init__(self, base_url: str, api_key: str, zone: str,
                 default_g_kwh: float, *, fetch: Fetch | None = None,
                 timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key
        self.zone = zone
        self.default_g_kwh = default_g_kwh
        self.fetch = fetch or _default_fetch(timeout_s)
        # Staleness marker for the degraded-mode path: False only when a
        # keyed fetch actually failed (the documented no-key fallback is
        # by-design, not stale).
        self.last_ok = True

    def latest(self, zone: str | None = None,
               default: float | None = None) -> float:
        """Latest gCO2eq/kWh for the zone; falls back to ``default`` (the
        configured global default if omitted) on any failure. Callers with
        a zone-specific prior pass it — a flat global fallback for one
        zone of a multi-region fleet could invert the cross-region carbon
        ordering a migration policy acts on."""
        zone = zone or self.zone
        fallback = self.default_g_kwh if default is None else default
        if not self.api_key:
            self.last_ok = True
            return fallback
        url = (f"{self.base_url}/carbon-intensity/latest?"
               f"{urllib.parse.urlencode({'zone': zone})}")
        try:
            raw = self.fetch(url, {"auth-token": self.api_key})
            doc = json.loads(raw)
            val = float(doc["carbonIntensity"])
        except Exception:  # noqa: BLE001 — documented graceful fallback
            self.last_ok = False
            return fallback
        self.last_ok = True
        return val


class SpotPriceClient:
    """Per-AZ spot prices from `aws ec2 describe-spot-price-history`.

    The reference has no spot feed at all — OpenCost reports realized node
    cost only — yet its whole Off-Peak profile is a bet on spot economics
    (`demo_20_offpeak_configure.sh:74-78`). This client closes that gap:
    it shells the AWS CLI (the reference's only
    AWS transport, `00_common.sh:24`) with an injectable runner, parses the
    newest price per availability zone, and returns {} on any failure so
    the tick can keep its synthetic prior instead of fabricating numbers.
    """

    def __init__(self, region: str, instance_type: str, *,
                 runner=None, window_hr: float = 3.0,
                 cache_ttl_s: float = 300.0,
                 failure_ttl_s: float = 60.0, clock=None):
        self.region = region
        self.instance_type = instance_type
        self.window_hr = window_hr
        # TTL cache (successes AND failures): spot prices move on minutes,
        # but the CLI call sits inside the 30s control tick — uncached, an
        # AWS brownout would block the loop for the runner's full
        # timeout+retry budget every tick. 300s keeps at
        # most one CLI call per ~10 ticks. Failures re-probe sooner
        # (failure_ttl_s): an empty result marks the whole tick stale
        # (degraded-mode input), and caching a single transient hiccup
        # for the full TTL would hold the controller in rule-fallback
        # for ~10 ticks after the CLI already recovered.
        self.cache_ttl_s = cache_ttl_s
        self.failure_ttl_s = failure_ttl_s
        self._cache: dict[str, float] | None = None
        self._cache_at = float("-inf")
        import time as _time
        self._clock = clock or _time.monotonic
        if runner is None:
            from ccka_tpu_torch.actuation.sink import _subprocess_runner
            runner = _subprocess_runner
        self.runner = runner

    def _argv(self) -> list[str]:
        import datetime
        start = (datetime.datetime.now(datetime.timezone.utc)
                 - datetime.timedelta(hours=self.window_hr))
        return ["aws", "ec2", "describe-spot-price-history",
                "--region", self.region,
                "--instance-types", self.instance_type,
                "--product-descriptions", "Linux/UNIX",
                "--start-time", start.strftime("%Y-%m-%dT%H:%M:%SZ"),
                "--output", "json"]

    def latest_by_zone(self) -> dict[str, float]:
        """{availability_zone: $/hr}, newest record per zone; {} if the
        CLI fails, returns junk, or reports no prices. Successes are
        cached for ``cache_ttl_s``; failures for the shorter
        ``failure_ttl_s`` — a broken CLI must not be re-tried every
        tick, but a transient hiccup must not pin the stale flag (and
        the controller's rule-fallback) for the full success TTL."""
        now = self._clock()
        if self._cache is not None:
            ttl = self.cache_ttl_s if self._cache else self.failure_ttl_s
            if now - self._cache_at < ttl:
                return dict(self._cache)
        prices = self._fetch()
        self._cache, self._cache_at = prices, now
        return dict(prices)

    def _fetch(self) -> dict[str, float]:
        rc, out = self.runner(self._argv())
        if rc != 0:
            return {}
        try:
            doc = json.loads(out)
        except json.JSONDecodeError:
            return {}
        best: dict[str, tuple[str, float]] = {}
        for rec in doc.get("SpotPriceHistory", []) or []:
            try:
                az = rec["AvailabilityZone"]
                price = float(rec["SpotPrice"])
                ts = str(rec.get("Timestamp", ""))
            except (KeyError, TypeError, ValueError):
                continue
            if price <= 0:
                continue
            if az not in best or ts > best[az][0]:  # ISO-8601 sorts
                best[az] = (ts, price)
        return {az: price for az, (_ts, price) in best.items()}


class InterruptionWarning:
    """One EC2 spot lifecycle event (EventBridge shape)."""

    __slots__ = ("instance_id", "action", "detail_type", "region")

    def __init__(self, instance_id: str, action: str, detail_type: str,
                 region: str = ""):
        self.instance_id = instance_id
        self.action = action              # "terminate" | "rebalance"
        self.detail_type = detail_type
        self.region = region

    def __repr__(self) -> str:  # diagnostics in controller logs
        return (f"InterruptionWarning({self.instance_id!r}, {self.action!r},"
                f" region={self.region!r})")


class SpotInterruptionFeed:
    """EC2 spot interruption/rebalance warnings from an SQS queue.

    This is the capability the reference explicitly disabled: Karpenter's
    ``settings.interruptionQueue=""`` (`05_karpenter.sh:136`) turns off the
    EventBridge→SQS interruption pipeline entirely, so a spot reclaim hits
    the demo cluster with zero notice. The simulator prices interruptions
    as a first-class stochastic process; this feed closes the live half:
    it polls the EventBridge-target SQS queue over the AWS CLI (the
    reference's only AWS transport, `00_common.sh:24`) with an injectable
    runner, parses `EC2 Spot Instance Interruption Warning` and
    `EC2 Instance Rebalance Recommendation` events, and acknowledges
    (deletes) consumed messages so a warning is acted on exactly once.

    Failures (CLI error, junk JSON, missing queue) return [] — the control
    loop keeps running on its stochastic prior, mirroring every other live
    client's graceful degradation.
    """

    _DETAIL_ACTIONS = {
        "EC2 Spot Instance Interruption Warning": "terminate",
        "EC2 Instance Rebalance Recommendation": "rebalance",
    }

    def __init__(self, queue_url: str, *, region: str = "",
                 runner=None, ack: bool = True, max_messages: int = 10):
        self.queue_url = queue_url
        self.region = region
        self.ack = ack
        self.max_messages = max(1, min(int(max_messages), 10))  # SQS cap
        if runner is None:
            from ccka_tpu_torch.actuation.sink import _subprocess_runner
            runner = _subprocess_runner
        self.runner = runner

    def _region_args(self) -> list[str]:
        return ["--region", self.region] if self.region else []

    def poll(self) -> list[InterruptionWarning]:
        rc, out = self.runner([
            "aws", "sqs", "receive-message", *self._region_args(),
            "--queue-url", self.queue_url,
            "--max-number-of-messages", str(self.max_messages),
            "--wait-time-seconds", "0",
            "--output", "json"])
        if rc != 0:
            return []
        try:
            doc = json.loads(out) if out.strip() else {}
        except json.JSONDecodeError:
            return []
        messages = doc.get("Messages", []) or []
        # Ack every received message in ONE batch call FIRST (including
        # junk and non-spot events routed here by a broad EventBridge
        # rule): an unacked message would redeliver and double-drain next
        # tick, a junk body would redeliver forever, and per-message
        # delete-message subprocesses would cost the control tick up to
        # ten sequential CLI spawns.
        handles = [m.get("ReceiptHandle", "") for m in messages]
        handles = [h for h in handles if h]
        if self.ack and handles:
            entries = [{"Id": str(i), "ReceiptHandle": h}
                       for i, h in enumerate(handles)]
            self.runner(["aws", "sqs", "delete-message-batch",
                         *self._region_args(),
                         "--queue-url", self.queue_url,
                         "--entries", json.dumps(entries)])
        warnings: list[InterruptionWarning] = []
        for msg in messages:
            try:
                event = json.loads(msg.get("Body", ""))
            except (json.JSONDecodeError, TypeError):
                continue
            action = self._DETAIL_ACTIONS.get(event.get("detail-type", ""))
            instance = (event.get("detail") or {}).get("instance-id", "")
            if action and instance:
                warnings.append(InterruptionWarning(
                    instance_id=instance, action=action,
                    detail_type=event["detail-type"],
                    region=event.get("region", self.region)))
        return warnings


class LiveSignalSource(SignalSource):
    """Assembles live clients into the common trace format.

    For tick-level control this scrapes all three families and emits a 1-step
    trace; for multi-step ``trace()`` requests it backfills from Prometheus
    range queries where available and falls back to the synthetic model for
    anything missing (so a cold-started live loop can still warm-start a
    policy). Demand is read from pending+running pod counts, the same
    kube-state-metrics series the reference's pipeline scrapes
    (`06_opencost.sh:324-327`).
    """

    PENDING_QUERY = 'sum(kube_pod_status_phase{phase="Pending"})'
    RUNNING_QUERY = 'sum(kube_pod_status_phase{phase="Running"})'
    # Per-pod series scoped to the workload namespace: classification into
    # the simulator's two demand classes (class 0 spot / class 1 od — the
    # burst generator's odd/even split) happens host-side from the pod
    # name, since kube_pod_status_phase carries no nodeSelector labels.
    POD_QUERY_TMPL = ('kube_pod_status_phase{{phase=~"Pending|Running",'
                      'namespace="{ns}"}} > 0')

    def __init__(self, cluster: ClusterConfig, workload: WorkloadConfig,
                 sim: SimConfig, signals: SignalsConfig,
                 *, fetch: Fetch | None = None,
                 spot_runner=None,
                 start_unix_s: float | None = None):
        import time
        self.cluster = cluster
        self.sim = sim
        self.signals = signals
        # Anchor tick 0 at real wall-clock (UTC) so time-of-day-shaped priors
        # (is_peak 09:00-21:00, diurnal curves) and Prometheus range windows
        # refer to actual hours, not ticks-since-process-start.
        self.start_unix_s = time.time() if start_unix_s is None else start_unix_s
        # Retry/backoff transport (the fault subsystem's live satellite):
        # every HTTP family rides one RetryingFetch, so a transient 500
        # costs a sub-second retry instead of the whole tick; exhaustion
        # surfaces through the per-family fallbacks below as a
        # ``last_scrape_stale`` tick, not an exception mid-controller.
        base_fetch = fetch or _default_fetch(signals.request_timeout_s)
        rfetch: Fetch = RetryingFetch(
            base_fetch, retries=signals.fetch_retries,
            backoff_s=signals.fetch_backoff_s,
            deadline_s=signals.request_timeout_s)
        self.prom = PrometheusClient(signals.prometheus_url, fetch=rfetch,
                                     timeout_s=signals.request_timeout_s)
        self.opencost = OpenCostClient(signals.opencost_url, fetch=rfetch,
                                       timeout_s=signals.request_timeout_s)
        self.carbon = CarbonIntensityClient(
            signals.carbon_url, signals.carbon_api_key, signals.carbon_zone,
            signals.carbon_default_g_kwh, fetch=rfetch,
            timeout_s=signals.request_timeout_s)
        self._synth = SyntheticSignalSource(cluster, workload, sim, signals,
                                            start_unix_s=self.start_unix_s)
        self.namespace = workload.namespace
        self.slo = SLOMetricsClient(self.prom, namespace=workload.namespace)
        # Spot feed: enabled by signals.spot_feed="aws" (CLI transport) or
        # by injecting a runner directly (tests / alternate transports).
        # Multi-region fleets query each region's price history separately.
        self.spot_clients: list[SpotPriceClient] = []
        if spot_runner is not None or signals.spot_feed == "aws":
            region_names = ([r.name for r in cluster.regions]
                            or [cluster.region])
            self.spot_clients = [
                SpotPriceClient(name, cluster.node_type.name,
                                runner=spot_runner)
                for name in region_names]
        # Grid zone + fallback intensity per cluster zone: in a multi-region
        # fleet each zone carries its region's ElectricityMaps zone id and
        # its region's base intensity as the API-failure fallback, so the
        # live carbon tick preserves cross-region divergence (a flat global
        # fallback for one failed zone could invert the ordering the
        # carbon-aware policy migrates on). Single-region: every zone
        # shares signals.carbon_zone and the global default.
        if cluster.regions:
            regs = [cluster.regions[i] for i in cluster.zone_region_index]
            self._zone_grid = [r.carbon_zone or signals.carbon_zone
                               for r in regs]
            self._zone_default = [r.carbon_base_g_kwh
                                  or signals.carbon_default_g_kwh
                                  for r in regs]
        else:
            self._zone_grid = [signals.carbon_zone] * cluster.n_zones
            self._zone_default = ([signals.carbon_default_g_kwh]
                                  * cluster.n_zones)

    def slo_snapshot(self) -> dict[str, float]:
        """Measured app-level SLO metrics for the controller's KPI line
        (absent series omitted — see :class:`SLOMetricsClient`)."""
        return self.slo.snapshot()

    _BURST_POD = re.compile(r"^burst-web-(\d+)-")

    def _demand_by_class(self) -> np.ndarray | None:
        """[C] per-class pod demand from namespace-scoped per-pod series;
        None when the query returns nothing (caller falls back)."""
        rows = self.prom.query(
            self.POD_QUERY_TMPL.format(ns=self.namespace))
        # Only per-pod series count: an endpoint that answers every query
        # with one anonymous aggregate (recording rules, test fakes) has
        # no class information — fall back to the aggregate path.
        rows = [(labels, val) for labels, val in rows if labels.get("pod")]
        if not rows:
            return None
        by_class = np.zeros(2, dtype=np.float64)
        for labels, val in rows:
            m = self._BURST_POD.match(labels.get("pod", ""))
            if m:
                # Generator convention (`actuation/burst.py`): odd index →
                # spot nodeSelector (class 0), even → on-demand (class 1).
                cls = 0 if int(m.group(1)) % 2 == 1 else 1
                by_class[cls] += val
            else:
                # Non-burst namespace pods: no capacity-type pin; spread.
                by_class += val / 2.0
        return by_class

    def meta(self) -> TraceMeta:
        return TraceMeta(source="live", start_unix_s=self.start_unix_s,
                         dt_s=self.sim.dt_s, zones=self.cluster.zones,
                         description=f"live scrape of {self.signals.prometheus_url}")

    def tick(self, t_index: int, *, seed: int = 0,
             device=None) -> ExogenousTrace:
        dev = resolve_device(device)
        nt = self.cluster.node_type
        base = self._synth.tick(t_index, seed=seed, device="cpu")
        # Staleness accounting for the degraded-mode controller: any
        # family whose (retried) scrape failed and fell back marks the
        # whole sample stale — the values are priors/held, not measured.
        stale = False

        od = base.od_price_hr.numpy().copy()
        demand = base.demand_pods.numpy().copy()

        # Spot prices: measured per-AZ history when the feed is enabled,
        # synthetic prior for any zone the feed doesn't cover. A feed
        # that is CONFIGURED but returned nothing at all (CLI failure or
        # empty history — latest_by_zone caches both as {}) is a stale
        # family too: every zone is then running on fabricated prices,
        # exactly what the degraded-mode machine must see.
        spot = base.spot_price_hr.numpy().copy()
        if self.spot_clients:
            by_az: dict[str, float] = {}
            for client in self.spot_clients:
                by_az.update(client.latest_by_zone())
            if not by_az:
                stale = True
            for i, zone in enumerate(self.cluster.zones):
                if zone in by_az:
                    spot[0, i] = by_az[zone]

        try:
            prices = self.opencost.node_prices_hr()
            if prices:
                mean_hr = float(np.mean(list(prices.values())))
                od[:] = max(mean_hr, nt.od_price_hr)
        except SignalUnavailable:
            stale = True

        # Demand: namespace-scoped per-pod series classified into the
        # simulator's spot/od demand classes (burst-web-<i> odd→spot,
        # even→od — the generator's own convention); falls back to the
        # whole-cluster aggregate with an even split when per-pod
        # series are unavailable (e.g. a stripped-down KSM).
        try:
            by_class = self._demand_by_class()
            if by_class is not None:
                demand[0, :] = by_class
            else:
                pending = self.prom.query(self.PENDING_QUERY)
                running = self.prom.query(self.RUNNING_QUERY)
                if pending or running:
                    total = (sum(v for _, v in pending)
                             + sum(v for _, v in running))
                    demand[0, :] = total / demand.shape[-1]
        except SignalUnavailable:
            stale = True

        # One API call per distinct grid zone (ElectricityMaps bills per
        # request; a 2-region 4-zone fleet makes 2 calls, not 4), each
        # falling back to its own region's base intensity.
        defaults = {g: d for g, d in zip(self._zone_grid,
                                         self._zone_default)}
        by_grid = {}
        for g in dict.fromkeys(self._zone_grid):
            by_grid[g] = self.carbon.latest(zone=g, default=defaults[g])
            if not self.carbon.last_ok:
                stale = True
        carbon = np.asarray([[by_grid[g] for g in self._zone_grid]],
                            dtype=np.float32)

        self.last_scrape_stale = stale
        return ExogenousTrace(
            spot_price_hr=as_f32(spot, dev), od_price_hr=as_f32(od, dev),
            carbon_g_kwh=as_f32(carbon, dev),
            demand_pods=as_f32(demand, dev),
            is_peak=base.is_peak.to(dev),
        )

    def trace(self, steps: int, *, seed: int = 0,
              device=None) -> ExogenousTrace:
        # Backfill a *historical* window ending at the wall-clock anchor:
        # tick i covers [start + i·dt, start + (i+1)·dt) with
        # start = anchor − steps·dt. The synthetic prior is re-anchored to
        # that same past window so demand, prices, carbon and is_peak all
        # refer to the same wall-clock instants; Prometheus samples are
        # placed by their returned timestamps, not by array position.
        end = self.start_unix_s
        start = end - steps * self.sim.dt_s
        synth_past = SyntheticSignalSource(
            self.cluster, self._synth.workload, self.sim, self.signals,
            start_unix_s=start)
        dev = resolve_device(device)
        base = synth_past.trace(steps, seed=seed, device="cpu")
        demand = base.demand_pods.numpy().copy()
        try:
            total: dict[int, float] = {}
            for q in (self.PENDING_QUERY, self.RUNNING_QUERY):
                series = self.prom.query_range(q, start=start, end=end,
                                               step_s=self.sim.dt_s)
                if series:
                    _, times, vals = series[0]
                    for t, v in zip(times, vals):
                        i = int(round((float(t) - start) / self.sim.dt_s))
                        if 0 <= i < steps:
                            total[i] = total.get(i, 0.0) + float(v)
            for i, v in total.items():
                demand[i, :] = v / demand.shape[-1]
        except SignalUnavailable:
            pass
        return ExogenousTrace(
            spot_price_hr=base.spot_price_hr.to(dev),
            od_price_hr=base.od_price_hr.to(dev),
            carbon_g_kwh=base.carbon_g_kwh.to(dev),
            demand_pods=as_f32(demand, dev),
            is_peak=base.is_peak.to(dev),
        )

    def batch_trace(self, steps: int, seeds, device=None) -> ExogenousTrace:
        """[B, T, ...]: :meth:`trace` per seed, stacked."""
        traces = [self.trace(steps, seed=int(s), device=device)
                  for s in seeds]
        return ExogenousTrace(*(torch.stack(xs) for xs in zip(*traces)))

    def history(self, t_index: int, steps: int, *, seed: int = 0,
                device=None) -> ExogenousTrace:
        """Forecaster input window (`ccka_tpu_torch.forecast`): ``trace()``
        already backfills the most recent ``steps`` ticks of measured
        history, so the base default's slice-of-trace indexing (built for
        tick-anchored synthetic/replay worlds) is skipped entirely."""
        del t_index  # live history always ends "now"
        return self.trace(steps, seed=seed, device=device)

    # The live planning default stays in the persistence family
    # (forecast.PersistenceForecaster is its zero-prior form): od price
    # below is exactly a last-value hold, demand/carbon hold the measured
    # *anomaly* against the diurnal prior. Controllers that want the
    # seasonal-naive or learned backends attach one to the MPC backend
    # (`MPCBackend(forecaster=...)`) — the controller then routes replans
    # through it instead of this method.
    default_forecaster = "persistence"

    def forecast(self, t_index: int, steps: int, *, seed: int = 0,
                 device=None) -> ExogenousTrace:
        """Forward window for receding-horizon planning: the synthetic
        diurnal prior shaped to NOW's measured levels (persistence-of-
        anomaly). The base default would slice ``trace()``, which for a
        live source is *backfilled history* frozen at the construction
        anchor — a planner fed that would optimize yesterday's window
        forever."""
        dev = resolve_device(device)
        prior = ExogenousTrace(*(x.numpy() for x in self._synth.forecast(
            t_index, steps, seed=seed, device="cpu")))
        now = ExogenousTrace(*(x.numpy() for x in self.tick(
            t_index, seed=seed, device="cpu")))

        def _lvl(x) -> float:
            return float(np.asarray(x).mean())

        d_ratio = _lvl(now.demand_pods) / max(
            _lvl(prior.demand_pods[:1]), 1e-6)
        # Carbon anomaly is PER ZONE: tick() measures each region's grid
        # separately, and collapsing to one scalar would hand the planner
        # the synthetic prior's cross-region ordering even when live
        # measurements disagree with it.
        c_ratio = (np.asarray(now.carbon_g_kwh)[0]
                   / np.maximum(np.asarray(prior.carbon_g_kwh)[0], 1e-6))
        od_now = _lvl(now.od_price_hr)
        return ExogenousTrace(
            spot_price_hr=as_f32(prior.spot_price_hr, dev),
            od_price_hr=as_f32(np.full_like(prior.od_price_hr, od_now), dev),
            carbon_g_kwh=as_f32(prior.carbon_g_kwh * c_ratio[None, :], dev),
            demand_pods=as_f32(prior.demand_pods * d_ratio, dev),
            is_peak=as_f32(prior.is_peak, dev),
        )


def make_signal_source(cluster: ClusterConfig, workload: WorkloadConfig,
                       sim: SimConfig, signals: SignalsConfig,
                       *, fetch: Fetch | None = None,
                       replay_path: str | None = None,
                       faults=None, workloads=None) -> SignalSource:
    """Factory keyed on ``signals.backend``.

    ``replay_path`` defaults to ``signals.replay_path``, so the replay
    backend is reachable purely through config/CCKA_* env overrides.

    ``faults`` (a ``config.FaultsConfig``) and ``workloads`` (a
    ``config.WorkloadsConfig``) reach the synthetic and replay
    backends, whose packed streams synthesize the disturbance/
    family-arrival lanes; the live backend ignores both — the live
    world supplies its own faults and its own tenant mix, and the
    degraded-mode machinery reacts to the REAL staleness flag instead.
    """
    from ccka_tpu_torch.config import ConfigError
    if signals.backend == "synthetic":
        return SyntheticSignalSource(cluster, workload, sim, signals,
                                     faults=faults, workloads=workloads)
    if signals.backend == "replay":
        from ccka_tpu_torch.signals.replay import ReplaySignalSource
        path = replay_path or signals.replay_path
        if not path:
            raise ConfigError("signals: replay backend requires replay_path")
        try:
            return ReplaySignalSource.from_file(path, faults=faults,
                                                workloads=workloads)
        except (OSError, KeyError, ValueError) as e:
            raise ConfigError(f"signals: cannot load replay trace "
                              f"{path!r}: {e}") from e
    if signals.backend == "live":
        return LiveSignalSource(cluster, workload, sim, signals, fetch=fetch)
    raise ConfigError(f"unknown signals backend {signals.backend!r}")
