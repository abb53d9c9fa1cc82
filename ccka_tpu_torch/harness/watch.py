"""The observability session — `demo_40_watch_observe.sh` as a component.

The PyTorch port's form of `ccka_tpu/harness/watch.py`: host code, the same
tunnel plan and session.

The reference's watch stage (`demo_40_watch_observe.sh:50-110`): kill stale
port-forwards, spawn background `kubectl port-forward` tunnels for Grafana
(:3000), OpenCost (:9090) and the AMP SigV4 proxy (:8005), wait for the
sockets, then smoke-query the metrics API (`/api/v1/label/__name__/values`
and `query?query=up`). This module is that session with the framework's
discipline: the plan is a pure function of config (printable in dry-run),
the process spawner and HTTP fetch are injectable (testable without a
cluster), and teardown is owned by the session object.
"""

from __future__ import annotations

import socket
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, Sequence
from urllib.parse import urlparse

from ccka_tpu_torch.config import FrameworkConfig


@dataclass(frozen=True)
class ForwardSpec:
    """One `kubectl port-forward` tunnel."""

    name: str          # human label, e.g. "grafana"
    target: str        # e.g. "svc/ccka-grafana"
    namespace: str
    local_port: int
    remote_port: int

    def argv(self) -> list[str]:
        return ["kubectl", "port-forward", "-n", self.namespace,
                self.target, f"{self.local_port}:{self.remote_port}"]


# Grafana's operator port (`demo_40_watch_observe.sh:56`).
GRAFANA_PORT = 3000


def watch_plan(cfg: FrameworkConfig) -> list[ForwardSpec]:
    """The tunnels a watch session needs, derived from config: Grafana
    (the stack `ccka dashboard` deploys), plus any localhost endpoint the
    signals config points at (Prometheus-compatible store, OpenCost) —
    the generalization of the reference's hardcoded 3000/8005/9090.
    This is THE source of the local observability ports: the preroll port
    gate (`harness.preroll._local_ports`) derives from it."""
    ns = cfg.workload.namespace
    plan = [ForwardSpec("grafana", "svc/ccka-grafana", ns,
                        GRAFANA_PORT, 3000)]
    prom = urlparse(cfg.signals.prometheus_url)
    if prom.hostname in ("localhost", "127.0.0.1") and prom.port:
        plan.append(ForwardSpec("prometheus", "svc/amp-sigv4-proxy",
                                "opencost", prom.port, 8005))
    oc = urlparse(cfg.signals.opencost_url)
    if oc.hostname in ("localhost", "127.0.0.1") and oc.port:
        plan.append(ForwardSpec("opencost", "svc/opencost", "opencost",
                                oc.port, 9090))
    return plan


def _wait_socket(port: int, *, timeout_s: float, sleep) -> bool:
    """demo_40_watch_observe.sh:93-96 (`/dev/tcp` poll) as a function."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(0.5)
        try:
            s.connect(("127.0.0.1", port))
            return True
        except OSError:
            sleep(0.25)
        finally:
            s.close()
    return False


class WatchSession:
    """Spawns the planned tunnels, waits for sockets, smoke-queries.

    ``spawner(argv) -> handle`` must return an object with ``terminate()``
    (subprocess.Popen by default); ``fetch`` is the signals-layer HTTP
    transport (injectable, like every live client).
    """

    def __init__(self, cfg: FrameworkConfig, *,
                 spawner: Callable[[Sequence[str]], object] | None = None,
                 fetch=None,
                 sleep: Callable[[float], None] = time.sleep,
                 socket_timeout_s: float = 15.0):
        self.cfg = cfg
        self.plan = watch_plan(cfg)
        self.spawner = spawner or (lambda argv: subprocess.Popen(
            list(argv), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL))
        self.fetch = fetch
        self.sleep = sleep
        self.socket_timeout_s = socket_timeout_s
        self._children: list = []

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> dict[str, bool]:
        """Spawn every tunnel; returns {name: tunnel_ready}.

        Ready means OUR child's socket: ports already occupied are
        reported not-ready up front (a stale port-forward squatting 3000
        would otherwise answer the socket probe and smoke() would query
        the wrong service — the demo_19 stale-PF hazard), and a child
        that died (e.g. kubectl exiting on 'address already in use')
        fails readiness even if something is listening.
        """
        from ccka_tpu_torch.harness.preroll import check_ports_free

        ports = [fw.local_port for fw in self.plan]
        # check_ports_free returns one check per requested port, in order.
        free = {port: check.ok
                for port, check in zip(
                    ports, check_ports_free(self.cfg, ports=ports))}
        ready = {}
        children_by_name = {}
        for fw in self.plan:
            if not free.get(fw.local_port, False):
                ready[fw.name] = False
                continue
            try:
                child = self.spawner(fw.argv())
            except OSError as e:  # no kubectl binary, exec failure
                raise RuntimeError(
                    f"watch: cannot spawn tunnel {fw.name!r} "
                    f"({' '.join(fw.argv()[:2])}): {e}") from e
            self._children.append(child)
            children_by_name[fw.name] = child
        for fw in self.plan:
            child = children_by_name.get(fw.name)
            if child is None:
                continue
            ok = _wait_socket(fw.local_port,
                              timeout_s=self.socket_timeout_s,
                              sleep=self.sleep)
            # A dead child means the socket (if any) is someone else's.
            poll = getattr(child, "poll", None)
            if ok and poll is not None and poll() is not None:
                ok = False
            ready[fw.name] = ok
        return ready

    def stop(self) -> None:
        for child in self._children:
            try:
                child.terminate()
                wait = getattr(child, "wait", None)
                if wait is not None:
                    try:
                        wait(timeout=5)
                    except Exception:  # noqa: BLE001 — escalate to kill
                        kill = getattr(child, "kill", None)
                        if kill is not None:
                            kill()
                            wait(timeout=5)
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
        self._children = []

    def __enter__(self) -> "WatchSession":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- smoke queries ------------------------------------------------------

    def smoke(self) -> dict:
        """The reference's two smoke queries against the metrics store
        (`demo_40_watch_observe.sh:106-110`): metric-name listing and
        `up`. Degrades to reachable=False per endpoint, never raises."""
        from ccka_tpu_torch.signals.live import PrometheusClient, SignalUnavailable

        prom = PrometheusClient(self.cfg.signals.prometheus_url,
                                fetch=self.fetch,
                                timeout_s=self.cfg.signals.request_timeout_s)
        out: dict = {"prometheus_url": self.cfg.signals.prometheus_url}
        try:
            names = prom.label_values("__name__")
            out["metric_names"] = len(names)
            out["has_ccka_series"] = any(n.startswith("ccka_")
                                         for n in names)
            up = prom.query("up")
            out["up_series"] = len(up)
            out["reachable"] = True
        except SignalUnavailable as e:
            out["reachable"] = False
            out["detail"] = str(e)[:200]
        return out
