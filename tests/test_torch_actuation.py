"""The port's actuation layer against the JAX package's, on the same
actions and command sequences.

Rendered NodePool patches, HPA and KEDA manifests, the lifecycle oracle,
the dry-run and fake-kubectl sinks' command streams, the chaos sink's
seeded fates and the reconciler's rounds must be identical, byte for
byte: the actions are the same values (a JAX action carried across with
`bridge.action`), and everything after them is host code."""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.actuation import chaos as jchaos
from ccka_tpu.actuation import patches as jpatches
from ccka_tpu.actuation import reconcile as jreconcile
from ccka_tpu.actuation import sink as jsink
from ccka_tpu.harness import lifecycle as jlifecycle
from ccka_tpu.policy import CarbonAwarePolicy as JCarbonAwarePolicy
from ccka_tpu.policy import RulePolicy as JRulePolicy
from ccka_tpu.sim import initial_state as jinitial_state
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.sim.rollout import exo_steps as jexo_steps
from ccka_tpu.train.flagship import load_flagship_backend as jflagship
from ccka_tpu_torch import bridge
from ccka_tpu_torch.actuation import chaos, patches, reconcile, sink
from ccka_tpu_torch.harness import lifecycle
from ccka_tpu_torch.policy.rule import RulePolicy, offpeak_action, peak_action

PRESETS = ("default", "multiregion")
# 08:58: tick 0 off-peak, tick 4 peak.
EDGE = 8 * 3600 + 58 * 60


def _jax_actions(preset: str) -> dict:
    """Rule, carbon and (multiregion) the shipped flagship's actions of the
    JAX package, off-peak and peak, as numpy dicts."""
    cfg = jcfg.PRESETS[preset]()
    src = JSource(cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
                  start_unix_s=EDGE)
    tr = src.trace(6, seed=3)
    state = jinitial_state(cfg)
    backends = {"rule": JRulePolicy(cfg.cluster),
                "carbon": JCarbonAwarePolicy(cfg.cluster)}
    if preset == "multiregion":
        backends["flagship"] = jflagship(cfg)[0]
    out = {}
    for name, b in backends.items():
        for t in (0, 5):
            exo = jax.tree.map(lambda x: x[t], jexo_steps(tr))
            a = b.decide(state, exo, jax.numpy.int32(t))
            out[(name, t)] = jax.tree.map(np.asarray, a)._asdict()
    return out


def _dump(patchsets) -> str:
    return json.dumps([[p.pool, p.disruption_merge, p.requirements_json,
                        p.requirements_json_fallback] for p in patchsets],
                      sort_keys=True)


@pytest.mark.parametrize("preset", PRESETS)
def test_patches_hpa_keda_byte_identical(preset):
    cfg_j, cfg_t = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    actions = _jax_actions(preset)
    assert len(actions) == (6 if preset == "multiregion" else 4)
    for key, a in actions.items():
        ja = jax.tree.map(jax.numpy.asarray,
                          jpatches.Action(**a))
        ta = bridge.action(a, device="cpu")
        for op in ("add", "replace"):
            assert _dump(patches.render_nodepool_patches(
                ta, cfg_t.cluster, op=op)) == _dump(
                jpatches.render_nodepool_patches(ja, cfg_j.cluster, op=op)), key
            jr = jpatches.render_region_nodepool_patches(ja, cfg_j.cluster,
                                                         op=op)
            tr = patches.render_region_nodepool_patches(ta, cfg_t.cluster,
                                                        op=op)
            assert list(jr) == list(tr)
            assert all(_dump(jr[r]) == _dump(tr[r]) for r in jr), key
        assert json.dumps(patches.render_hpa_manifests(
            ta, cfg_t.cluster, cfg_t.workload)) == json.dumps(
            jpatches.render_hpa_manifests(ja, cfg_j.cluster, cfg_j.workload))
        assert json.dumps(patches.render_keda_scaledobject(
            ta, "q", "123456789012", region="us-east-2")) == json.dumps(
            jpatches.render_keda_scaledobject(ja, "q", "123456789012",
                                              region="us-east-2"))


@pytest.mark.parametrize("preset", PRESETS)
def test_port_rule_profiles_render_the_reference_bytes(preset):
    """The port's own rule profiles (not carried across) render JAX's
    bytes, with the action on the CPU or batched as the controller
    holds it."""
    from ccka_tpu.policy import offpeak_action as joff
    from ccka_tpu.policy import peak_action as jpeak

    cfg_j, cfg_t = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    for tf, jf, op in ((offpeak_action, joff, "replace"),
                       (peak_action, jpeak, "add")):
        assert _dump(patches.render_nodepool_patches(
            tf(cfg_t.cluster, "cpu"), cfg_t.cluster, op=op)) == _dump(
            jpatches.render_nodepool_patches(jf(cfg_j.cluster),
                                             cfg_j.cluster, op=op))


def _patchsets(preset: str, which: str):
    cfg_j, cfg_t = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    a = _jax_actions(preset)[(which, 5)]
    ja = jax.tree.map(jax.numpy.asarray, jpatches.Action(**a))
    return (jpatches.render_nodepool_patches(ja, cfg_j.cluster, op="add"),
            patches.render_nodepool_patches(bridge.action(a, "cpu"),
                                            cfg_t.cluster, op="add"))


@pytest.mark.parametrize("schema", ["primary", "fallback"])
def test_lifecycle_verify_identical(schema):
    jps, tps = _patchsets("default", "carbon")
    kw = ({} if schema == "primary"
          else {"schema_path": jpatches.FALLBACK_PATH})
    expect = {p.pool: (p.disruption_merge["spec"]["disruption"]
                       ["consolidationPolicy"],
                       p.requirements_json[0]["value"][1]["values"])
              for p in jps}
    expect["missing-pool"] = ("WhenEmpty", ["spot"])
    js, ts = jsink.DryRunSink(**kw), sink.DryRunSink(**kw)
    jco, tco = jlifecycle.ConfigureObserve(js), lifecycle.ConfigureObserve(ts)
    jstage = jlifecycle.Stage("s", jps, expect)
    tstage = lifecycle.Stage("s", tps, expect)
    assert jco.run(jstage) == tco.run(tstage)
    assert jco.verify(jstage) == tco.verify(tstage)
    assert js.rendered() == ts.rendered()


def _fake_kubectl(store: dict, calls: list):
    """tests/test_controller.py's fake kubectl, over one store."""
    def run(argv):
        calls.append(list(argv))
        if argv[1] == "patch":
            name, ptype, patch = argv[3], argv[4], json.loads(argv[6])
            entry = store.setdefault(name, {})
            if ptype == "--type=merge":
                entry.setdefault("spec", {}).setdefault(
                    "disruption", {}).update(patch["spec"]["disruption"])
            else:
                entry["requirements"] = patch[0]["value"]
            return 0, "patched"
        if argv[1] == "get":
            entry = store.get(argv[3])
            if entry is None:
                return 1, "not found"
            if "jsonpath" in argv[-1]:
                return 0, "\n".join(
                    f"{r['key']}=In:{' '.join(r['values'])}"
                    for r in entry.get("requirements", []))
            return 0, json.dumps({"spec": {
                "disruption": entry.get("spec", {}).get("disruption", {}),
                "template": {"spec": {
                    "requirements": entry.get("requirements", [])}}}})
        return 0, ""
    return run


@pytest.mark.parametrize("which", ["rule", "carbon", "flagship"])
def test_sink_command_streams_identical(which):
    jps, tps = _patchsets("multiregion", which)
    js, ts = jsink.DryRunSink(), sink.DryRunSink()
    assert [vars(r) for r in js.apply_all(jps)] == [
        vars(r) for r in ts.apply_all(tps)]
    manifest = {"kind": "Deployment",
                "metadata": {"name": "w", "namespace": "nov-22"}}
    for s in (js, ts):
        s.apply_manifest(manifest)
        s.delete_object("Deployment", "w", namespace="nov-22")
    assert js.rendered() == ts.rendered()
    assert [js.observed_state(p.pool) for p in jps] == [
        ts.observed_state(p.pool) for p in tps]
    jcalls, tcalls = [], []
    jk = jsink.KubectlSink(_fake_kubectl({}, jcalls))
    tk = sink.KubectlSink(_fake_kubectl({}, tcalls))
    assert [vars(r) for r in jk.apply_all(jps)] == [
        vars(r) for r in tk.apply_all(tps)]
    jk.drain_node("n1")
    tk.drain_node("n1")
    assert jcalls == tcalls and len(tcalls) == 2 * 3 + 2
    ctx_calls: list = []
    ctx = sink.context_runner("east", _fake_kubectl({}, ctx_calls))
    ctx(["kubectl", "get", "nodepool", "x", "-o", "json"])
    assert ctx_calls[0][:3] == ["kubectl", "--context", "east"]


@pytest.mark.parametrize("intensity", sorted(jcfg.CHAOS_PRESETS))
@pytest.mark.parametrize("seed", [0, 7])
def test_chaos_fates_identical_per_seed(intensity, seed):
    jps, tps = _patchsets("default", "rule")
    js, ts = jsink.DryRunSink(), sink.DryRunSink()
    jc = jchaos.make_chaos_sink(js, intensity, seed=seed)
    tc = chaos.make_chaos_sink(ts, intensity, seed=seed)
    for _ in range(12):
        assert [vars(r) for r in jc.apply_all(jps)] == [
            vars(r) for r in tc.apply_all(tps)]
        jc.apply_manifest({"kind": "HPA", "metadata": {"name": "h"}})
        tc.apply_manifest({"kind": "HPA", "metadata": {"name": "h"}})
    assert jc.stats == tc.stats
    # "off" draws nothing; otherwise a refused merge patch skips its
    # pool's requirements patches, so the count depends on the fates.
    assert (jc.stats["commands"] == 0) == (intensity == "off")
    assert js.rendered() == ts.rendered()
    with pytest.raises(ValueError, match="unknown chaos intensity"):
        chaos.make_chaos_sink(ts, "apocalyptic")


@pytest.mark.parametrize("intensity", sorted(jcfg.CHAOS_PRESETS))
def test_reconciler_rounds_identical_under_chaos(intensity):
    """Under each preset, the two reconcilers converge or give up on the
    same rounds, retries, failures and backoff sleeps, tick after tick."""
    jps, tps = _patchsets("multiregion", "carbon")
    sleeps = {"j": [], "t": []}
    recs = {
        "j": jreconcile.Reconciler(
            jchaos.make_chaos_sink(jsink.DryRunSink(), intensity, seed=5),
            max_rounds=3, seed=11, sleep_fn=sleeps["j"].append),
        "t": reconcile.Reconciler(
            chaos.make_chaos_sink(sink.DryRunSink(), intensity, seed=5),
            max_rounds=3, seed=11, sleep_fn=sleeps["t"].append)}
    gave_up = 0
    for _ in range(16):
        jo, to = recs["j"].converge(jps), recs["t"].converge(tps)
        assert (jo.converged, jo.rounds, jo.retries, jo.failures,
                jo.diverged, jo.divergence) == (
            to.converged, to.rounds, to.retries, to.failures, to.diverged,
            to.divergence)
        assert [vars(r) for r in jo.results] == [vars(r) for r in to.results]
        gave_up += not to.converged
    assert sleeps["j"] == sleeps["t"]
    assert recs["t"].giveups_total == gave_up
    if intensity == "off":
        assert gave_up == 0 and sleeps["t"] == []
    else:
        assert sleeps["t"]        # some round retried
    # Pools read back from the same rendered intent.
    for jp, tp in zip(jps, tps):
        assert reconcile.verify_pool(
            recs["t"].sink.observed_state(tp.pool), tp) == \
            jreconcile.verify_pool(recs["j"].sink.observed_state(jp.pool), jp)


def test_hpa_scale_clip_on_device_tensors():
    """A batched action on any device renders as its values do."""
    cfg = tcfg.default_config()
    a = RulePolicy(cfg.cluster, device="cpu").peak
    a = a._replace(hpa_scale=torch.tensor([9.0, 0.01]))
    hpa = patches.render_hpa_manifests(a, cfg.cluster, cfg.workload)
    per = cfg.workload.total_pods // 2
    assert [h["spec"]["maxReplicas"] for h in hpa] == [
        max(1, int(round(per * 4.0))), max(1, int(round(per * 0.1)))]
