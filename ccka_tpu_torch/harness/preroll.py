"""Preroll assertion gate — `demo_18_preroll_check.sh` as a component.

The PyTorch port's form of `ccka_tpu/harness/preroll.py`. The config,
signals, NodePool, burst, aws-auth and port checks are JAX's; the two
accelerator checks are the card's: :func:`check_torch_device` and
:func:`check_kernels_build` take the JAX backend and jit checks' places.
Under the default device (the card) neither passes on a host without
one.

The reference asserts, each with exit-1 + remediation hint (`:23-81`):
namespace exists, zero leftover burst workloads, NodePools in the neutral
profile, dashboard ports free, and the Karpenter node role mapped in
aws-auth. The framework analog checks the pieces *this* stack depends on,
in two tiers:

- always: config validity, the torch device asked for is present, the
  rollout kernels build and agree with their plain version on a short
  rollout (on the CPU: the plain rollout runs), signal source produces a
  sane tick;
- --live additionally: both NodePools exist and are neutral
  (`demo_18:42-55`), zero leftover burst workloads (`demo_18:30-39`), the
  Karpenter node role is mapped in aws-auth (`demo_18:67-81`), and the
  operator dashboard ports are free (`demo_18:58-65` — a stale
  port-forward squatting 3000/8005/9090 breaks the observe session).

Each check returns (ok, detail) and the runner prints a pass/fail table —
the same contract as the bash gate, machine-checkable from pytest.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Sequence

from ccka_tpu_torch.config import ConfigError, FrameworkConfig


@dataclass
class PrerollCheck:
    name: str
    ok: bool
    detail: str = ""
    hint: str = ""


def check_config(cfg: FrameworkConfig) -> PrerollCheck:
    try:
        cfg.validate()
        return PrerollCheck("config-valid", True)
    except ConfigError as e:
        return PrerollCheck("config-valid", False, str(e),
                            hint="fix the flagged field or CCKA_* override")


def check_torch_device(device=None) -> PrerollCheck:
    """The device the caller asked for (the card unless ``device`` names
    another) is present: on ``cuda`` the card's name and compute
    capability, failing with a hint on a host without a GPU."""
    try:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                return PrerollCheck(
                    "torch-device", False,
                    f"device {dev} asked for, but torch sees no CUDA "
                    f"device (torch {torch.__version__})",
                    hint="run on a GPU host, or pass --device cpu for the "
                         "plain PyTorch version")
            idx = dev.index if dev.index is not None else 0
            major, minor = torch.cuda.get_device_capability(idx)
            return PrerollCheck(
                "torch-device", True,
                f"{torch.cuda.get_device_name(idx)}, compute capability "
                f"{major}.{minor}")
        if dev.type != "cpu":
            return PrerollCheck("torch-device", False,
                                f"unsupported device {dev}",
                                hint="pass --device cuda or --device cpu")
        return PrerollCheck("torch-device", True,
                            "cpu (the plain PyTorch version)")
    except Exception as e:  # noqa: BLE001 — any device failure blocks
        return PrerollCheck("torch-device", False, repr(e)[:300],
                            hint="check the torch installation / CUDA "
                                 "runtime")


PREROLL_TICKS = 4


def check_kernels_build(cfg: FrameworkConfig, device=None) -> PrerollCheck:
    """A 4-tick neutral-action rollout of the synthetic source's trace.
    On ``cuda``: the rollout kernels' source is built (at first use) and
    loaded through `kernels/build.py`, the rule-profile kernel
    (`sim/megakernel.py::megakernel_rollout_summary`) runs the rollout
    and is held against its plain version on the card (every field's
    relative difference within 1e-4). On ``cpu``: the plain rollout
    runs."""
    try:
        import torch

        from ccka_tpu_torch import resolve_device
        from ccka_tpu_torch.policy.rule import neutral_action
        from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
        from ccka_tpu_torch.sim import megakernel as mk
        from ccka_tpu_torch.sim.types import SimParams

        dev = resolve_device(device)
        params = SimParams.from_config(cfg, device=dev)
        src = SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                    cfg.signals)
        tr = src.batch_trace(PREROLL_TICKS, [0], device=dev)
        act = neutral_action(cfg.cluster, dev)
        if dev.type == "cpu":
            s = mk.megakernel_rollout_summary(params, act, act, tr,
                                              stochastic=False, device=dev)
            if not all(bool(torch.isfinite(v).all()) for v in s):
                return PrerollCheck("kernels-build", False,
                                    "plain rollout gave non-finite fields",
                                    hint="simulator regression — run "
                                         "pytest tests/test_torch_rollout.py")
            return PrerollCheck("kernels-build", True,
                                f"plain {PREROLL_TICKS}-tick rollout on the "
                                f"cpu")
        from ccka_tpu_torch.kernels import build

        lib = build.library("rollout_profiles.cu")
        got = mk.megakernel_rollout_summary(params, act, act, tr,
                                            stochastic=False, device=dev)
        want = mk._plain_summary(params, act, act, tr, 0, False)
        worst, same = 0.0, True
        for f in got._fields:
            a = getattr(got, f).double()
            b = getattr(want, f).double()
            same = same and bool(torch.equal(getattr(got, f),
                                             getattr(want, f)))
            rel = float(((a - b).abs() / b.abs().clamp_min(1e-9)).max())
            worst = max(worst, 0.0 if math.isnan(rel) else rel)
        if worst > 1e-4:
            return PrerollCheck("kernels-build", False,
                                f"rule kernel against its plain version: "
                                f"largest relative difference {worst:.3g}",
                                hint="kernel regression — run pytest "
                                     "tests/test_torch_kernels.py -m gpu")
        return PrerollCheck("kernels-build", True,
                            f"{os.path.basename(lib._name)}; rule kernel, "
                            f"{PREROLL_TICKS}-tick "
                            f"neutral rollout, "
                            + ("bitwise its plain version" if same else
                               f"within {worst:.3g} of its plain version"))
    except Exception as e:  # noqa: BLE001
        return PrerollCheck("kernels-build", False, repr(e)[:300],
                            hint="nvcc / CUDA toolkit missing or kernel "
                                 "build failed — see kernels/build.py")


def check_signals(cfg: FrameworkConfig) -> PrerollCheck:
    try:
        import numpy as np

        from ccka_tpu_torch.signals.live import make_signal_source
        src = make_signal_source(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals, faults=cfg.faults,
                                 workloads=cfg.workloads)
        # Host-side sanity of the signal clients: the tick lands on
        # the CPU whatever device the rollout checks use.
        tick = src.tick(0, device="cpu")
        arr = np.asarray(tick.carbon_g_kwh)
        if not np.all(np.isfinite(arr)) or np.any(arr <= 0):
            return PrerollCheck("signals-sane", False,
                                f"carbon tick {arr.tolist()}",
                                hint="check signal backend configuration")
        return PrerollCheck("signals-sane", True,
                            f"backend={cfg.signals.backend}")
    except Exception as e:  # noqa: BLE001
        return PrerollCheck("signals-sane", False, repr(e)[:300],
                            hint="check signals.* config / endpoints")


def _local_ports(cfg: FrameworkConfig) -> list[int]:
    """Ports the observe session will port-forward onto this host — derived
    from the SAME tunnel plan `ccka watch` opens (`harness.watch.
    watch_plan`), so the preroll port gate can never drift from the
    session it protects (the framework analog of demo_18's hardcoded
    3000/8005/9090 list)."""
    from ccka_tpu_torch.harness.watch import watch_plan

    return sorted({fw.local_port for fw in watch_plan(cfg)})


def check_ports_free(cfg: FrameworkConfig,
                     ports: Sequence[int] | None = None) -> list[PrerollCheck]:
    """Dashboard ports are bindable (`demo_18_preroll_check.sh:58-65`).

    A port already bound almost always means a stale `kubectl port-forward`
    from a previous observe session — the reference's remediation (kill the
    PF, `demo_19_reset_policies.sh:39-55`) is the hint here.
    """
    import socket

    out = []
    for port in (ports if ports is not None else _local_ports(cfg)):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.bind(("127.0.0.1", port))
            out.append(PrerollCheck(f"port-{port}-free", True))
        except OSError as e:
            out.append(PrerollCheck(
                f"port-{port}-free", False, str(e),
                hint="stale port-forward? run `ccka reset` or kill the "
                     f"process listening on {port} (demo_19:39-55)"))
        finally:
            s.close()
    return out


def check_nodepools_live(cfg: FrameworkConfig, runner) -> list[PrerollCheck]:
    """Live-cluster checks (demo_18:42-55): pools exist and are neutral."""
    out = []
    for pool in cfg.cluster.pools:
        rc, got = runner(["kubectl", "get", "nodepool", pool.name, "-o",
                          "jsonpath={.spec.disruption.consolidationPolicy}"])
        if rc != 0:
            out.append(PrerollCheck(f"nodepool-{pool.name}", False, got,
                                    hint="create the NodePool (ccka bootstrap)"))
        elif got.strip() not in ("WhenEmpty", ""):
            out.append(PrerollCheck(
                f"nodepool-{pool.name}", False,
                f"consolidationPolicy={got.strip()!r} not neutral",
                hint="run `ccka reset` first (demo_19 analog)"))
        else:
            out.append(PrerollCheck(f"nodepool-{pool.name}", True))
    return out


def check_no_leftover_burst(cfg: FrameworkConfig, runner) -> PrerollCheck:
    """Zero leftover burst workloads (demo_18:30-39) — a stale burst set
    would contaminate the scale-out the new run is about to measure."""
    from ccka_tpu_torch.actuation.burst import BURST_GROUP
    ns = cfg.workload.namespace
    rc, got = runner(["kubectl", "get", "deploy", "-n", ns,
                      "-l", f"group={BURST_GROUP}", "-o", "name"])
    if rc != 0:
        # A missing namespace is genuinely clean; any other kubectl failure
        # (no binary, unreachable API server) must fail the gate — "can't
        # see the cluster" is not "the cluster is clean".
        if "NotFound" in got:
            return PrerollCheck("no-leftover-burst", True,
                                "namespace absent")
        return PrerollCheck("no-leftover-burst", False, got[:200],
                            hint="kubectl unreachable — fix cluster access")
    leftovers = [ln for ln in got.strip().splitlines() if ln.strip()]
    if leftovers:
        return PrerollCheck("no-leftover-burst", False,
                            f"{len(leftovers)} burst deployment(s) present",
                            hint="run `ccka burst --delete` (demo_50 subset)")
    return PrerollCheck("no-leftover-burst", True)


def check_aws_auth(cfg: FrameworkConfig, runner) -> PrerollCheck:
    """Karpenter node role mapped in aws-auth (demo_18:67-81) — without it
    provisioned nodes never join and every burst pod stays Pending."""
    from ccka_tpu_torch.actuation.bootstrap import karpenter_node_role, role_mapped
    role = karpenter_node_role(cfg.cluster)
    rc, got = runner(["kubectl", "get", "configmap", "aws-auth",
                      "-n", "kube-system",
                      "-o", "jsonpath={.data.mapRoles}"])
    if rc != 0:
        return PrerollCheck("aws-auth-mapping", False, got[:200],
                            hint="is this an EKS cluster with kubectl access?")
    # Shared matcher with ensure_node_role_mapping: exact rolearn entries
    # only (no prefix collisions, no username/groups false positives).
    if not role_mapped(got, role_name=role):
        return PrerollCheck("aws-auth-mapping", False,
                            f"{role} not in mapRoles",
                            hint="run `ccka map-nodes --account-id ...` "
                                 "(demo_15 analog)")
    return PrerollCheck("aws-auth-mapping", True)


def run_preroll(cfg: FrameworkConfig, *, live: bool = False,
                runner=None, echo: bool = True, device=None) -> int:
    """Run all checks; returns 0 iff all pass (exit-code contract of
    demo_18_preroll_check.sh). ``device`` is the torch device the two
    accelerator checks ask for (the card unless it names another)."""
    device_check = check_torch_device(device)
    checks: list[PrerollCheck] = [
        check_config(cfg),
        device_check,
        (check_kernels_build(cfg, device) if device_check.ok else
         PrerollCheck("kernels-build", False, "skipped: no device",
                      hint=device_check.hint)),
        check_signals(cfg),
    ]
    if live:
        from ccka_tpu_torch.actuation.sink import _subprocess_runner
        r = runner or _subprocess_runner
        checks.extend(check_nodepools_live(cfg, r))
        checks.append(check_no_leftover_burst(cfg, r))
        checks.append(check_aws_auth(cfg, r))
        checks.extend(check_ports_free(cfg))

    ok = True
    for c in checks:
        ok &= c.ok
        if echo:
            mark = "PASS" if c.ok else "FAIL"
            line = f"[{mark}] {c.name}"
            if c.detail:
                line += f" — {c.detail}"
            if not c.ok and c.hint:
                line += f"  (hint: {c.hint})"
            print(line)
    if echo:
        print(f"[{'ok' if ok else 'err'}] preroll "
              f"{'passed' if ok else 'FAILED'}")
    return 0 if ok else 1
