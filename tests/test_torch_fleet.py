"""The port's fleet controller against the JAX package's, on one world.

The two packages sample fleet traces from different random streams, so
both fleets are handed the same traces: JAX's synthetic device batch,
served by a test source on each side. N = 8-16 clusters, 4-8 ticks.
Standards, set from the dtypes before the runs:

- rule and carbon: packed action rows and per-cluster rows within 1e-5
  relative (pending pods, remainders of the demand, at the demand's
  scale; values at 0 within 1e-6), per-sink command streams
  byte-identical: the same float32 arithmetic in two frameworks;
- the multiregion flagship (JAX's shipped params in both): per-cluster
  rows within 1e-3 relative, action rows and the chosen-vs-shadow
  divergence columns within 5e-3 relative (a bf16
  torso: a sum added in another order can round a hidden unit one bf16
  step, 2^-8, the other way, and the squashing keeps a fraction of
  that); its command streams are not compared (consolidateAfter renders
  whole seconds of a continuous action);
- within the port: pipelined runs, snapshot resumes and batched decides
  bitwise.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.actuation.sink import DryRunSink as JDryRunSink
from ccka_tpu.harness.fleet import FleetController as JFleet
from ccka_tpu.policy import CarbonAwarePolicy as JCarbon
from ccka_tpu.policy import RulePolicy as JRule
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.train.checkpoint import load_params_npz as jload_params
from ccka_tpu.train.flagship import flagship_checkpoint_path as jckpt
from ccka_tpu.train.ppo import PPOBackend as JPPO
from ccka_tpu_torch import bridge, cli
from ccka_tpu_torch.actuation.sink import DryRunSink
from ccka_tpu_torch.harness import fleet as fl
from ccka_tpu_torch.harness.snapshot import SnapshotError, load_snapshot
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
from ccka_tpu_torch.sim.rollout import initial_state
from ccka_tpu_torch.train.ppo import PPOBackend

HORIZON = 16
OVERRIDES = {"sim.horizon_steps": 16}


class JFixed:
    """JAX side: serves given traces as the device batch."""

    def __init__(self, traces):
        self.traces = traces

    def batch_trace_device(self, steps, key, n, **_kw):
        return jax.tree.map(lambda x: x[:n, :steps], self.traces)


class TFixed:
    """Port side: the same traces, bridged."""

    def __init__(self, traces):
        self.traces = bridge.trace(jax.tree.map(np.asarray,
                                                traces)._asdict(), "cpu")

    def batch_trace_device(self, steps, generator, batch, device=None):
        return ExogenousTrace(*(x[:batch, :steps].to(device)
                                for x in self.traces))


def _configs(preset: str):
    return (jcfg.PRESETS[preset]().with_overrides(**OVERRIDES),
            tcfg.PRESETS[preset]().with_overrides(**OVERRIDES))


def _jax_traces(cj, n: int, seed: int):
    return JSource(cj.cluster, cj.workload, cj.sim, cj.signals,
                   start_unix_s=8 * 3600 + 58 * 60).batch_trace_device(
        HORIZON, jax.random.key(seed), n)


def _backends(name: str, cj, ct):
    if name == "rule":
        return JRule(cj.cluster), RulePolicy(ct.cluster, device="cpu")
    if name == "carbon":
        return JCarbon(cj.cluster), CarbonAwarePolicy(ct.cluster,
                                                      device="cpu")
    params, _ = jload_params(jckpt(cj))
    return (JPPO(cj, params),
            PPOBackend(ct, jax.tree.map(np.asarray, params), device="cpu"))


def _commands(ctrl) -> list:
    return [[c.render() for c in s.commands] for s in ctrl.sinks]


def _jax_rows(ctrl, ticks: int) -> list:
    rows = []
    for t in range(ticks):
        disp = ctrl._dispatch(t)
        rows.append((np.asarray(disp.packed), np.asarray(disp.per_metrics)))
        ctrl._harvest_and_fanout(disp)
    return rows


def _port_rows(ctrl, ticks: int, t0: int = 0) -> list:
    rows = []
    for t in range(t0, ticks):
        ctrl.tick(t)
        rows.append(ctrl.last_rows[1:])
    return rows


def _pending_cols(ct) -> list:
    from ccka_tpu_torch.obs.decisions import decision_row_layout

    lay = decision_row_layout(ct.cluster)
    return [3] + [lay.col(c) for c in ("pend_c0", "pend_c1",
                                       "shadow_pend_c0", "shadow_pend_c1")]


def _assert_rows_close(jrows, trows, ct, rtol, action_rtol=None):
    """Rows within ``rtol`` relative; the action rows and the chosen-vs-
    shadow divergence columns (differences of actions) within
    ``action_rtol``."""
    from ccka_tpu_torch.obs.decisions import decision_row_layout

    lay = decision_row_layout(ct.cluster)
    pend = _pending_cols(ct)
    total = float(ct.workload.total_pods)
    action_rtol = action_rtol or rtol
    tol = np.full(lay.width, rtol)
    tol[[lay.col("div_max_abs"), lay.col("div_l2")]] = action_rtol
    for (jp, jq), (tp, tq) in zip(jrows, trows):
        assert tp.shape == jp.shape and tq.shape == jq.shape
        np.testing.assert_allclose(tp, jp, rtol=action_rtol, atol=1e-6)
        scale = np.maximum(np.abs(jq), 1e-6 / rtol)
        scale[:, pend] = np.maximum(scale[:, pend], total)
        assert np.all(np.abs(tq - jq) / scale <= tol)


@pytest.mark.parametrize("name,preset", [("rule", "default"),
                                         ("carbon", "default"),
                                         ("flagship", "multiregion")])
def test_fleet_rows_and_commands_match_jax(name, preset):
    cj, ct = _configs(preset)
    n, ticks = 12, 6
    traces = _jax_traces(cj, n, seed=3)
    jb, tb = _backends(name, cj, ct)
    jctrl = JFleet(cj, jb, JFixed(traces), [JDryRunSink() for _ in range(n)],
                   horizon_ticks=HORIZON, seed=3, fanout_workers=1)
    tctrl = fl.FleetController(ct, tb, TFixed(traces),
                               [DryRunSink() for _ in range(n)],
                               horizon_ticks=HORIZON, seed=3,
                               fanout_workers=1, device="cpu")
    jrows = _jax_rows(jctrl, ticks)
    trows = _port_rows(tctrl, ticks)
    if name == "flagship":
        _assert_rows_close(jrows, trows, ct, 1e-3, action_rtol=5e-3)
    else:
        _assert_rows_close(jrows, trows, ct, 1e-5)
    if name != "flagship":
        assert _commands(tctrl) == _commands(jctrl)
    np.testing.assert_allclose(tctrl.states.time_s.numpy(),
                               np.asarray(jctrl.states.time_s))
    jctrl.close()
    tctrl.close()


def _fleet(ct, backend, n, seed=5, workers=8, sinks=None, **kw):
    src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals)
    return fl.FleetController(ct, backend, src,
                              sinks or [DryRunSink() for _ in range(n)],
                              horizon_ticks=8, seed=seed,
                              fanout_workers=workers, device="cpu", **kw)


@pytest.mark.parametrize("name", ["rule", "carbon"])
def test_pipelined_run_equals_sequential_ticks(name):
    _, ct = _configs("default")
    backend = _backends(name, *_configs("default"))[1]
    seq = _fleet(ct, backend, 16, workers=1)
    pipe = _fleet(ct, backend, 16)
    r_seq = [seq.tick(t) for t in range(5)]
    r_pipe = pipe.run(5)
    pipe.close()
    key = ("t", "applied", "slo_ok", "cost_usd_hr", "carbon_g_hr",
           "pending_pods")
    assert [[getattr(r, k) for k in key] for r in r_seq] == \
        [[getattr(r, k) for k in key] for r in r_pipe]
    assert _commands(seq) == _commands(pipe)
    assert all(torch.equal(a, b) for a, b in zip(seq.states, pipe.states))


def test_snapshot_restore_resumes_bitwise(tmp_path):
    _, ct = _configs("default")
    backend = CarbonAwarePolicy(ct.cluster, device="cpu")
    full = _fleet(ct, backend, 8)
    full_rows = _port_rows(full, 6)
    first = _fleet(ct, backend, 8)
    _port_rows(first, 3)
    path = first.write_snapshot(str(tmp_path / "fleet.snap"), 3)
    # The restarted controller drives the same clusters (sinks).
    resumed = _fleet(ct, backend, 8, sinks=first.sinks)
    start = resumed.restore(load_snapshot(path))
    assert start == 3
    rows = _port_rows(resumed, 6, t0=start)
    for (a, b), (c, d) in zip(rows, full_rows[3:]):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert all(torch.equal(a, b) for a, b in zip(resumed.states,
                                                 full.states))
    assert _commands(resumed) == _commands(full)
    with pytest.raises(SnapshotError, match="clusters"):
        _fleet(ct, backend, 4).restore(load_snapshot(path))
    with pytest.raises(SnapshotError, match="seed"):
        _fleet(ct, backend, 8, seed=9).restore(load_snapshot(path))


def test_snapshot_body_matches_jax_layout(tmp_path):
    """The body's keys are JAX's, less the PRNG key the deterministic
    estimate never draws from; the states encode under JAX's key paths."""
    cj, ct = _configs("default")
    jctrl = JFleet(cj, JRule(cj.cluster), JSource(
        cj.cluster, cj.workload, cj.sim, cj.signals),
        [JDryRunSink() for _ in range(4)], horizon_ticks=8, seed=2)
    tctrl = _fleet(ct, RulePolicy(ct.cluster, device="cpu"), 4, seed=2)
    jb, tb = jctrl.snapshot_body(3), tctrl.snapshot_body(3)
    assert set(jb) - set(tb) == {"prng_key"} and set(tb) <= set(jb)
    assert set(jb["states"]) == set(tb["states"])
    assert {k: jb[k] for k in tb if k != "states"} == \
        {k: tb[k] for k in tb if k != "states"}


def test_source_without_device_batches_refuses():
    _, ct = _configs("default")

    class NoBatch:
        pass

    with pytest.raises(ValueError, match="device-batched"):
        fl.FleetController(ct, RulePolicy(ct.cluster, device="cpu"),
                           NoBatch(), [DryRunSink()], device="cpu")


def test_flagship_decides_a_fleet_row_for_row_as_one_cluster():
    """PPOBackend.decide is batch-first: N clusters decided at once give,
    row for row, what each cluster decided alone gives."""
    cj, ct = _configs("multiregion")
    _, backend = _backends("flagship", cj, ct)
    n = 9
    traces = TFixed(_jax_traces(cj, n, seed=4)).batch_trace_device(
        HORIZON, None, n, device="cpu")
    from ccka_tpu_torch.sim.dynamics import ExoStep, step
    from ccka_tpu_torch.sim.types import SimParams

    params = SimParams.from_config(ct, device="cpu")
    states = initial_state(ct, n, device="cpu")
    for t in range(4):
        exo = ExoStep(*(x[:, t] for x in traces))
        batched = backend.decide(states, exo, t)
        for i in range(n):
            one = backend.decide(type(states)(*(x[i:i + 1] for x in states)),
                                 ExoStep(*(x[i:i + 1] for x in exo)), t)
            for a, b in zip(batched, one):
                assert torch.equal(a[i], b[0])
        states, _ = step(params, states, batched, exo)


def test_only_capturable_backends_reach_the_graph():
    from ccka_tpu_torch.train.mpc import MPCBackend

    _, ct = _configs("default")
    for ok in (RulePolicy(ct.cluster, device="cpu"),
               CarbonAwarePolicy(ct.cluster, device="cpu")):
        fl._require_capturable(ok, "backend")
    with pytest.raises(ValueError, match="MPCBackend.*cannot be captured"):
        fl._require_capturable(MPCBackend(ct, device="cpu"), "backend")


def test_fleet_actions_vary_and_state_advances():
    _, ct = _configs("default")
    ctrl = _fleet(ct, CarbonAwarePolicy(ct.cluster, device="cpu"), 16,
                  seed=11)
    packed, new_states, per = ctrl._fleet_tick(ctrl.states, 0)
    assert packed.shape[0] == 16 and per.shape == (16, ctrl._dec_layout.width)
    zw00 = [ctrl._unpack_action(packed[i, :-1].numpy()).zone_weight[0, 0]
            for i in range(16)]
    assert np.std(zw00) > 1e-6
    ctrl.run(3)
    assert torch.all(ctrl.states.time_s == 3 * ct.sim.dt_s)
    assert torch.all(ctrl.states.acc_cost_usd > 0)


def test_default_device_raises_without_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, ct = _configs("default")
    rule = RulePolicy(ct.cluster, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl.fleet_controller_from_config(ct, rule, 4)
    src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim, ct.signals)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl.FleetController(ct, rule, src, [DryRunSink()])
    with pytest.raises(SystemExit, match="--device cuda"):
        cli.main(["fleet", "--clusters", "2", "--ticks", "1"])


def test_controller_commands_unchanged_by_the_rowwise_decide():
    """The flagship's row-by-row decide leaves the single-cluster
    controller's command stream what the module's forward gives."""
    from ccka_tpu_torch.harness.controller import Controller
    from ccka_tpu_torch.models import latent_to_action
    from ccka_tpu_torch.policy.base import observe

    cj, ct = _configs("multiregion")
    _, rowwise = _backends("flagship", cj, ct)

    class ModuleForward(PPOBackend):
        def decide(self, state, exo, t):
            obs = observe(self.params_sim, state, exo).flatten()
            return latent_to_action(self.net(obs)[0], self.cluster)

    forward = ModuleForward(ct, rowwise.params, device="cpu")
    streams = []
    for backend in (rowwise, forward):
        sinks = {r.name: DryRunSink() for r in ct.cluster.regions}
        src = SyntheticSignalSource(ct.cluster, ct.workload, ct.sim,
                                    ct.signals, start_unix_s=8 * 3600.0)
        Controller(ct, backend, src, sinks, device="cpu", interval_s=0.0,
                   log_fn=lambda s: None).run(12)
        streams.append([c.render() for s in sinks.values()
                        for c in s.commands])
    assert streams[0] == streams[1] and streams[0]
