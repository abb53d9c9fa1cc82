"""The port's trainers against the JAX package's on the same inputs.

- Run logs written by one package and read by the other; training states
  saved and loaded, a tampered one refused.
- The optimizer (`train/optim.py`) against optax's chain of global-norm
  clipping and Adam on the cosine schedule.
- The ActorCritic initialiser's distributions against flax's.
- PPO: one and three iterations against ``PPOTrainer._iteration_fn`` from
  the same params, windows and action noise (the JAX key schedule,
  reproduced here), with every mode of the update as a case.
- Imitation: ``collect_dataset`` on JAX's traces, ``imitate`` on JAX's
  dataset, init params and minibatch indices.
- The flagship's selection rules on the same dicts, and a tiny
  ``train_flagship`` whose npz the JAX package loads.

The trainers' cases on the card (a CUDA-default entry point, a 64-member
population launch bitwise member by member) are in
`tests/test_torch_kernels.py`, which imports no JAX.

The randomness inside the step (spot interruptions) cannot cross the
frameworks (Threefry is not Philox), so every cross-framework case sets
``sim.spot_interruption_rate_hr = 0``: the stochastic step is then the
deterministic one in both packages.

Tolerances. From the same params the collected rollouts agree to float
rounding (rewards, attainment: 1e-5 relative). The bf16 torso
differentiates differently in XLA and in torch, so the losses after one
update and the parameters move apart: losses and diagnostics are held to
the relative tolerances stated per case (measured: most under a tenth of
them; the cosine case's KL and policy loss at 0.8 and 0.6, the reward of
the third chained iteration at 0.65), parameters in units of ``lr * k``
after k Adam steps (measured: the largest at 0.93 of ``2 lr k``): Adam
normalizes each coordinate, so one whose gradient is float noise can
move by about ``lr`` a step in either direction in either package
(``2 * lr * k`` apart at most).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ccka_tpu.config as jcfg
import ccka_tpu_torch.config as tcfg
from ccka_tpu.models import ActorCritic as JActorCritic
from ccka_tpu.obs import runlog as jrunlog
from ccka_tpu.policy import CarbonAwarePolicy as JCarbon
from ccka_tpu.signals.synthetic import SyntheticSignalSource as JSource
from ccka_tpu.train import checkpoint as jcheckpoint
from ccka_tpu.train import flagship as jflagship
from ccka_tpu.train import imitate as jimitate
from ccka_tpu.train.ppo import PPOTrainer as JTrainer
from ccka_tpu_torch import bridge
from ccka_tpu_torch.models.nets import ActorCritic
from ccka_tpu_torch.obs import runlog
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.train import checkpoint, flagship, imitate, optim
from ccka_tpu_torch.train.ppo import PPOBackend, PPOTrainer

B, T = 8, 16
_RATE0 = {"sim.spot_interruption_rate_hr": 0.0, "train.batch_clusters": B,
          "train.unroll_steps": T}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(**overrides):
    ov = dict(_RATE0, **overrides)
    return (jcfg.PRESETS["default"]().with_overrides(**ov),
            tcfg.PRESETS["default"]().with_overrides(**ov))


def _trace(jtr):
    return bridge.trace(_np(jtr)._asdict(), "cpu")


# ---- run logs ---------------------------------------------------------------


def test_runlog_crosses_both_ways(tmp_path):
    """A log written by either package reads back in the other with the
    same records and the same summary; both refuse unregistered events."""
    for i, (writer, reader) in enumerate(((jrunlog, runlog),
                                          (runlog, jrunlog))):
        path = str(tmp_path / f"run{i}.jsonl")
        with writer.RunLog(path, kind="flagship", echo=lambda s: None,
                           meta={"seed": 3}) as rl:
            rl.note("rule baseline")
            rl.event("gen", generation=0, best_fitness=0.97, improved=True)
            rl.event("eval", iteration=5, score=1.01, wins_both=False)
        with open(path, "a") as fh:
            fh.write('{"event": "gen", "gener')      # a torn final line
        recs, stats = reader.read_runlog(path, with_stats=True)
        want = writer.read_runlog(path)
        assert recs == want and stats == {"torn_tail": 1}
        assert [r["event"] for r in recs] == ["start", "note", "gen", "eval",
                                              "end"]
        assert reader.summarize_runlog(recs) == writer.summarize_runlog(recs)
    assert runlog.RUNLOG_EVENTS == jrunlog.RUNLOG_EVENTS
    with pytest.raises(ValueError, match="unregistered"):
        runlog.RunLog(None, echo=lambda s: None).event("made_up")


# ---- training states -------------------------------------------------------


def test_state_round_trip_and_tamper_refusal(tmp_path):
    """A whole PPO train state (params, Adam moments, worlds, generator,
    scalars) saved at two steps: the latest loads by default, bitwise,
    with its NamedTuple types given a target; a changed array refuses."""
    _, tc = _configs()
    trainer = PPOTrainer(tc, device="cpu")
    ts = trainer.init_state(4)
    ts = ts._replace(iteration=7, violation_weight=0.031)
    root = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(root) is None
    checkpoint.save_state(root, trainer.init_state(1), step=3)
    path = checkpoint.save_state(root, ts, step=12)
    assert checkpoint.latest_step(root) == 12
    back = checkpoint.load_state(root, target=ts)
    assert type(back) is type(ts) and back.iteration == 7
    assert back.violation_weight == 0.031
    for k, v in ts.params.items():
        assert torch.equal(back.params[k], v)
    assert type(back.env_states) is type(ts.env_states)
    for a, b in zip(ts.env_states, back.env_states):
        assert torch.equal(a, b)
    assert back.opt_state.count == 0
    assert torch.equal(back.generator.get_state(), ts.generator.get_state())
    plain = checkpoint.load_state(root, step=12)        # no target: dicts
    assert plain["iteration"] == 7 and "Dense_0.weight" in plain["params"]

    npz = os.path.join(path, "state.npz")
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    flat["params/log_std"] = flat["params/log_std"] + 1e-3
    np.savez(npz, **flat)
    with pytest.raises(ValueError, match="digest mismatch"):
        checkpoint.load_state(root, step=12)


# ---- the optimizer ----------------------------------------------------------


@pytest.mark.parametrize("norm", [0.4, 3.0])
def test_optimizer_matches_optax_chain(norm):
    """``chain(clip_by_global_norm(1.0), adam(cosine_decay_schedule(3e-4,
    12, alpha=0.05)))`` for five steps on gradients of global norm
    ``norm`` (below and above the clip): clipped gradients within 1e-6
    relative, schedule values within 1e-7 relative, every update within
    2e-5 relative of optax's (XLA's CPU code for the quotient lands up to
    1e-5 from the float32-rounded one, `test_torch_mpc.py`)."""
    rng = np.random.default_rng(3)
    shapes = [(4, 16), (16,), (3,)]
    sched = optax.cosine_decay_schedule(3e-4, 12, alpha=0.05)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    params = [np.zeros(s, np.float32) for s in shapes]
    jstate = jopt.init([jnp.asarray(p) for p in params])
    port = optim.Chain(optim.cosine_decay_schedule(3e-4, 12, alpha=0.05))
    tstate = port.init([torch.from_numpy(p) for p in params])
    for i in range(5):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                            for x in g))
        g = [(x * (norm / total)).astype(np.float32) for x in g]
        jupd, jstate = jopt.update([jnp.asarray(x) for x in g], jstate)
        tupd, tstate = port.update([torch.from_numpy(x) for x in g], tstate)
        for a, b in zip(jupd, tupd):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                       atol=1e-12)
        clipped = optim.clip_by_global_norm([torch.from_numpy(x) for x in g],
                                            1.0)
        jclip, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(x) for x in g], optax.EmptyState())
        for a, b in zip(jclip, clipped):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
        assert abs(optim.cosine_decay_schedule(3e-4, 12, alpha=0.05)(i)
                   - float(sched(i))) <= 1e-7 * float(sched(i))
    assert tstate.count == 5


# ---- the initialiser --------------------------------------------------------


def test_actor_critic_initialiser_matches_flax():
    """flax's ``Dense`` default (``lecun_normal``: a normal truncated at
    two standard deviations, variance 1 / fan_in) on the torso and the
    critic, zero biases, a zero actor-mean head and a constant log_std:
    every weight within the truncation bound, and the standard deviation
    of each layer within 6 % of flax's own draw and of sqrt(1/fan_in)
    (the sampling error of 4608-16384 draws is under 2 %)."""
    net = ActorCritic(29, 16, init_log_std=-1.25,
                      generator=torch.Generator().manual_seed(0))
    jp = JActorCritic(act_dim=16, init_log_std=-1.25).init(
        jax.random.key(0), jnp.zeros(29))["params"]
    for name, fan_in in (("Dense_0", 29), ("Dense_1", 128),
                         ("critic", 128)):
        w = getattr(net, name).weight.detach().numpy()
        want = np.sqrt(1.0 / fan_in)
        jw = np.asarray(jp[name]["kernel"])
        assert np.abs(w).max() <= 2.0 * want / 0.87962566103423978 + 1e-6
        assert abs(w.std() / want - 1) < 0.06
        assert abs(w.std() / jw.std() - 1) < 0.06
        assert abs(w.mean()) < 0.05 * want
        assert not getattr(net, name).bias.detach().numpy().any()
        assert not np.asarray(jp[name]["bias"]).any()
    assert not net.actor_mean.weight.detach().numpy().any()
    assert torch.equal(net.log_std.detach(), torch.full((16,), -1.25))
    again = ActorCritic(29, 16, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.Dense_0.weight, net.Dense_0.weight)


# ---- PPO --------------------------------------------------------------------


def _jax_noise(key, n_ticks: int, shape) -> np.ndarray:
    """The action noise of JAX's collect scan: ``key, k_act, k_step =
    split(key, 3)`` a tick, ``normal(k_act, [B, A])``; returned [B, T, A]."""
    out = []
    for _ in range(n_ticks):
        key, k_act, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.normal(k_act, shape)))
    return np.stack(out, axis=1)


MODES = {
    "base": {},
    "warmup": {"train.critic_warmup_iters": 2},
    "anchor": {"train.anchor_coef": 0.5},
    "actor_lr_scale": {"train.actor_lr_scale": 0.3},
    "adv_clip": {"train.adv_clip": 0.5},
    "lagrangian": {"train.attain_target": 0.99},
    "cosine": {"train.lr_decay_iters": 3},
}


def _run_ppo(mode: str, iterations: int):
    """``iterations`` PPO iterations in both packages from the JAX
    trainer's init, on the same windows and noise; returns the two
    trainers' diagnostics per iteration and the final params."""
    jc, tc = _configs(**MODES[mode])
    j0 = JTrainer(jc).init_state(0)
    anchor = None
    if mode == "anchor":
        anchor = jax.tree.map(lambda x: x, j0.params)
        anchor["params"]["actor_mean"]["kernel"] = 0.05 * jax.random.normal(
            jax.random.key(9), anchor["params"]["actor_mean"]["kernel"].shape)
    jt = JTrainer(jc, anchor_params=anchor)
    tt = PPOTrainer(tc, anchor_params=None if anchor is None else _np(anchor),
                    device="cpu")
    jts = j0
    ts = tt.fresh_state(_np(j0.params))
    src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    win = src.batch_trace(iterations * T + 1, range(5, 5 + B))
    jd, td = [], []
    for it in range(iterations):
        w = jax.tree.map(lambda x: x[:, it * T:it * T + T + 1], win)
        noise = _jax_noise(jts.key, T, (B, tt.act_dim))
        jts, jdiag = jt._iteration_fn(jts, w)
        ts, tdiag = tt.iteration(ts, _trace(w), torch.from_numpy(noise))
        jd.append({k: float(v) for k, v in jdiag._asdict().items()})
        td.append({k: float(v) for k, v in tdiag._asdict().items()})
    jp = bridge.actor_critic_from_flax(_np(jts.params))
    return jd, td, jp, ts, tc


# Relative tolerances of the diagnostics: the rollout quantities to float
# rounding; the losses of an update whose parameters already differ by
# the bf16 torso's gradients (policy and KL are differences of nearly
# equal log-probabilities).
_DIAG_RTOL = {"mean_reward": 1e-5, "attainment": 1e-5,
              "violation_weight": 1e-5, "entropy": 1e-5,
              "value_loss": 2e-3, "policy_loss": 2e-2, "approx_kl": 2e-2}


def _assert_ppo(jd, td, jp, ts, tc, steps_per_iter):
    for i, (a, b) in enumerate(zip(jd, td)):
        for k, rtol in _DIAG_RTOL.items():
            assert abs(a[k] - b[k]) <= rtol * max(abs(a[k]), 1e-3), (
                i, k, a[k], b[k])
    k = steps_per_iter * len(jd)
    lr = tc.train.learning_rate
    for name, want in jp.items():
        got = ts.params[name]
        d = float((got - want).abs().max())
        assert d <= 2.0 * lr * k, (name, d, 2.0 * lr * k)
        # The bulk moves together: the median coordinate within a tenth.
        assert float((got - want).abs().median()) <= 0.2 * lr * k, name


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ppo_iteration_matches_jax(mode):
    """One iteration per mode, from the same params, window and noise."""
    jd, td, jp, ts, tc = _run_ppo(mode, 1)
    _assert_ppo(jd, td, jp, ts, tc, tc.train.ppo_epochs)
    if mode == "warmup":
        assert jd[0]["policy_loss"] != 0.0   # computed, not applied
        assert torch.equal(ts.params["log_std"],
                           torch.full_like(ts.params["log_std"], -0.5))
    if mode == "lagrangian":
        assert ts.violation_weight != tc.train.slo_violation_weight


def test_three_ppo_iterations_match_jax():
    """Three chained iterations (the worlds, optimizer state and key carry
    across), then the same standards at k = 12 Adam steps."""
    jd, td, jp, ts, tc = _run_ppo("base", 3)
    _assert_ppo(jd, td, jp, ts, tc, tc.train.ppo_epochs)
    assert ts.iteration == 3 and ts.opt_state.count <= 12


def test_kl_early_stop_keeps_the_optimizer_state():
    """A KL target of zero stops at the first epoch that measures a KL
    above it: later epochs apply no update and the Adam count stays where
    the stop found it, as the JAX trainer keeps its old state."""
    jc, tc = _configs(**{"train.ppo_target_kl": 0.0})
    tt = PPOTrainer(tc, device="cpu")
    ts = tt.init_state(2)
    src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    ts, diag = tt.iteration(ts, _trace(src.batch_trace(T + 1, range(B))))
    assert 1 <= ts.opt_state.count < tc.train.ppo_epochs
    assert float(diag.approx_kl) > 0.0


# ---- imitation --------------------------------------------------------------


def test_collect_dataset_matches_jax():
    """The carbon teacher over JAX's device traces (``key(seed)``): the
    same rows in the same (time-major) order, observations within 1e-6
    relative, targets (the inverse codec's logs: XLA's and torch's differ
    in the last bits) and returns within 1e-5."""
    jc, tc = _configs()
    src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    want = jimitate.collect_dataset(jc, JCarbon(jc.cluster), src,
                                    batch_clusters=B, steps=48, seed=4)
    jtr = src.batch_trace_device(48, jax.random.key(4), B)
    got = imitate.collect_dataset(tc, CarbonAwarePolicy(tc.cluster,
                                                        device="cpu"),
                                  None, traces=_trace(jtr), seed=4,
                                  device="cpu")
    assert tuple(got.obs.shape) == np.asarray(want.obs).shape == (48 * B, 29)
    np.testing.assert_allclose(got.obs.numpy(), np.asarray(want.obs),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.target.numpy(), np.asarray(want.target),
                               rtol=1e-5, atol=1e-5)
    assert float(got.target.abs().max()) == imitate._TARGET_CLIP
    np.testing.assert_allclose(got.returns.numpy(), np.asarray(want.returns),
                               rtol=1e-5, atol=1e-5)


def test_imitate_matches_jax():
    """30 steps on JAX's dataset from JAX's init params with JAX's minibatch
    indices (``key(seed + 2)`` split a step): the two MSEs of the first
    step within 5e-5 relative and of every later recorded step within
    5e-3, the params within ``2 lr k``."""
    jc, tc = _configs()
    src = JSource(jc.cluster, jc.workload, jc.sim, jc.signals)
    data = jimitate.collect_dataset(jc, JCarbon(jc.cluster), src,
                                    batch_clusters=B, steps=32, seed=1)
    iters, mb, seed = 30, 64, 1
    jparams, jhist = jimitate.imitate(jc, None, None, dataset=data,
                                      iterations=iters, minibatch=mb,
                                      seed=seed)
    key = jax.random.key(seed + 2)
    init = JActorCritic(act_dim=16, init_log_std=jc.train.init_log_std).init(
        key, data.obs[0])
    idx = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(sub, (mb,), 0,
                                                 data.obs.shape[0])))
    params, hist = imitate.imitate(
        tc, None, None, dataset=imitate.ImitationBatch(
            *(torch.from_numpy(np.array(x)) for x in data)),
        iterations=iters, minibatch=mb, seed=seed, init_params=_np(init),
        indices=np.stack(idx), device="cpu")
    assert [h["iteration"] for h in hist] == [h["iteration"] for h in jhist]
    for a, b in zip(jhist, hist):
        for k in ("actor_mse", "critic_mse"):
            # Step 0 from the same params: the bf16 forwards' rounding
            # (measured 1.3e-5); later steps after Adam has moved the two
            # apart (measured up to 1.1e-3).
            rtol = 5e-5 if a["iteration"] == 0 else 5e-3
            assert abs(a[k] - b[k]) <= rtol * abs(a[k]), (a, b)
    want = bridge.actor_critic_from_flax(_np(jparams))
    got = bridge.actor_critic_from_flax(params)
    for name in want:
        assert float((got[name] - want[name]).abs().max()) <= 2e-3 * iters


# ---- the flagship -----------------------------------------------------------


def _result(usd, co2, attain):
    return {"usd_per_slo_hour": usd, "g_co2_per_kreq": co2,
            "slo_attainment": attain}


def test_selection_rules_match_jax():
    """``score_vs_rule``, ``beats_teacher`` and the candidate tiers on the
    same result dicts: equal in both packages, ties and the attainment
    slack included."""
    rule = _result(1.0, 1.0, 0.95)
    teacher = _result(0.99, 0.97, 0.951)
    rng = np.random.default_rng(0)
    cases = [_result(1.0, 1.0, 0.95), _result(0.98, 1.0, 0.95),
             _result(0.97, 0.96, 0.9495), _result(0.97, 0.96, 0.9485),
             _result(1.0001, 0.9, 0.96), _result(0.99, 0.97, 0.951)]
    cases += [_result(*rng.uniform([0.95, 0.95, 0.94], [1.03, 1.03, 0.96]))
              for _ in range(40)]
    for res in cases:
        assert flagship.score_vs_rule(res, rule) == jflagship.score_vs_rule(
            res, rule)
        assert (flagship.beats_teacher(res, teacher)
                == jflagship.beats_teacher(res, teacher))
        wins, _ = jflagship.score_vs_rule(res, rule)
        jtier = (2 if wins and jflagship.beats_teacher(res, teacher)
                 else 1 if wins else 0)
        assert flagship.candidate_tier(res, wins, teacher) == jtier
        assert flagship.candidate_tier(res, wins, None) == (1 if wins else 0)


@pytest.mark.parametrize("refine", ["ppo", "cem"])
def test_tiny_train_flagship_saves_an_npz_jax_loads(refine, tmp_path,
                                                     monkeypatch):
    """A tiny run of each refinement (scratch + PPO; distilled carbon +
    CEM on the plain engine, its generations shortened to 32 ticks and 3
    members through CEMConfig's defaults), saved as `main` saves it: JAX's
    ``load_params_npz`` verifies its digest, and JAX's ActorCritic and the
    port's PPOBackend compute the same mean action from it (1e-5)."""
    from ccka_tpu_torch.train import cem

    monkeypatch.setattr(cem, "CEMConfig", functools.partial(
        cem.CEMConfig, eval_steps=32, popsize=3))
    tc = tcfg.PRESETS["default"]().with_overrides(
        **{"train.batch_clusters": B, "train.unroll_steps": 8})
    kw = (dict(init_from="scratch", refine="ppo") if refine == "ppo" else
          dict(init_from="distill:carbon", refine="cem", distill_iterations=5))
    out = flagship.train_flagship(
        tc, iterations=2, eval_every=1, eval_steps=32, n_eval_traces=2,
        log=lambda s: None, runlog=str(tmp_path / "run.jsonl"),
        device="cpu", **kw)
    meta = out["meta"]
    assert meta["selected_iteration"] in {0, 1, 2}
    assert meta["cem_engine"] == ("lax" if refine == "cem" else None)
    recs = runlog.read_runlog(str(tmp_path / "run.jsonl"))
    assert recs[-1]["event"] == "end"
    path = checkpoint.save_params_npz(str(tmp_path / "f.npz"), out["params"],
                                      meta=meta)
    jparams, jmeta = jcheckpoint.load_params_npz(path)
    assert jmeta[jcheckpoint.PARAMS_DIGEST_KEY] == checkpoint.params_digest(
        out["params"])
    obs = np.random.default_rng(1).uniform(0, 50, (4, 29)).astype(np.float32)
    jmean, _, _ = JActorCritic(act_dim=16).apply(jparams, jnp.asarray(obs))
    tmean, _, _ = PPOBackend(tc, out["params"], device="cpu").net(
        torch.from_numpy(obs))
    np.testing.assert_allclose(tmean.detach().numpy(), np.asarray(jmean),
                               rtol=1e-5, atol=1e-5)


def test_population_plain_summary_matches_the_member_loop():
    """The population launch's plain version (what `chip_smoke.py` holds
    the 64-member launch against, and what the CPU entry runs) against a
    member loop of `kernel_numerics_action_fn` rollouts on the same stream
    and seed: every member within NEURAL_MEAN_PARITY_TOLERANCES, the
    card's standard; the CPU entry returns the plain version bit for
    bit."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.train.cem import _flatten, _unflatten

    tc = tcfg.PRESETS["multiregion"]()
    net = flagship.load_flagship_backend(tc, device="cpu")[0].params
    flat, spec = _flatten(net)
    pop = _unflatten(flat[None] + 5e-3 * torch.randn(
        (4, flat.shape[0]), generator=torch.Generator().manual_seed(1)),
        spec)
    src = SyntheticSignalSource(tc.cluster, tc.workload, tc.sim, tc.signals)
    stream = src.packed_trace_device(96, 3, 16, device="cpu")
    params = SimParams.from_config(tc, device="cpu")
    P, Z = tc.cluster.n_pools, tc.cluster.n_zones
    got = mk.population_plain_summary(params, tc.cluster, pop, stream, 96, 7)
    assert tuple(got.cost_usd.shape) == (4, 16)
    entry = mk.neural_megakernel_summary_from_packed(params, tc.cluster, pop,
                                                     stream, 96, 7)
    assert all(torch.equal(a, b) for a, b in zip(got, entry))
    traces = mk.unpack_exo(stream, 96, Z)
    for m in range(4):
        want = mk._plain_rollout(
            params, P, Z, mk.kernel_numerics_action_fn(
                mk._tree_map(lambda x: x[m], pop), tc.cluster, params),
            traces, 7, True)
        assert not mk.mean_parity_violations(
            type(got)(*(x[m] for x in got)), want,
            mk.NEURAL_MEAN_PARITY_TOLERANCES)
    assert float((got.cost_usd[1] - got.cost_usd[0]).abs().max()) > 0
