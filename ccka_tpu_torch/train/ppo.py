"""PPO actor-critic over a batch of simulated clusters, and its policy as a
decision backend.

The PyTorch form of `ccka_tpu/train/ppo.py`. One iteration is two plain
functions over batch-first tensors:

- :meth:`PPOTrainer.collect` steps the persistent worlds [B] through a
  window of T ticks under the stochastic policy and records the buffers
  (observations, latent actions, their log-probabilities, values,
  rewards, SLO ticks; [B, T, ...]) and the bootstrap value at the window
  edge (episodes are continuing, so GAE bootstraps from the critic);
- :meth:`PPOTrainer.update` computes GAE over those buffers and runs the
  clipped-surrogate epochs by autograd, with every mode of the JAX
  trainer: critic warm-up (``critic_warmup_iters``), the anchor penalty
  (``anchor_coef``), per-head learning rates (``actor_lr_scale``), the
  KL early stop (later epochs apply no update and keep the optimizer
  state), advantage clipping (``adv_clip``) and the Lagrangian SLO price
  (``attain_target``) adapted on a deterministic shadow rollout.

Draws: the action noise of every tick and the world seed of every window
come from the trainer state's ``torch.Generator``; ``collect(noise=...)``
takes the noise from the caller instead. The spot interruptions of a
window are the Philox stream of its world seed (`sim/random.py`),
addressed by (cluster, tick).

The optimizer is optax's ``chain(clip_by_global_norm(1.0), adam(lr))``
with the cosine schedule when ``lr_decay_iters`` > 0
(`train/optim.py`); its count steps once per epoch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import functional_call

from ccka_tpu_torch import bridge, resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.models import ActorCritic, latent_dim, latent_to_action
from ccka_tpu_torch.models.nets import rowwise_policy_mean
from ccka_tpu_torch.policy.base import PolicyBackend, observe
from ccka_tpu_torch.signals.base import ExogenousTrace
from ccka_tpu_torch.sim.dynamics import ExoStep, clip
from ccka_tpu_torch.sim.rollout import exo_steps, initial_state, rollout
from ccka_tpu_torch.sim.types import Action, ClusterState, SimParams
from ccka_tpu_torch.train.objective import step_reward
from ccka_tpu_torch.train.optim import AdamState, Chain, cosine_decay_schedule

# Reward scale: step costs are O($0.01-0.1); normalize into O(1) for
# stable advantage and value optimization.
_REWARD_SCALE = 100.0
# Offset of the shadow rollout's world seed from the window's.
_SHADOW_SEED = 7919
_WORLD_SEEDS = 2 ** 30


class PPOTrainState(NamedTuple):
    params: dict                 # ActorCritic state dict (name -> tensor)
    opt_state: AdamState
    env_states: ClusterState     # [B, ...] persistent worlds
    generator: torch.Generator   # action noise and world seeds
    iteration: int
    # Adaptive SLO-violation price (Lagrange multiplier) when
    # train.attain_target > 0; otherwise pinned at the config's value.
    violation_weight: float


class PPODiagnostics(NamedTuple):
    mean_reward: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    attainment: torch.Tensor         # mean batch attainment this window
    violation_weight: torch.Tensor   # multiplier used this iteration


class PPOBuffers(NamedTuple):
    """What :meth:`PPOTrainer.collect` records over one window."""

    obs: torch.Tensor           # [B, T, F]
    u: torch.Tensor             # [B, T, A] sampled latent actions
    logp: torch.Tensor          # [B, T]
    value: torch.Tensor         # [B, T]
    reward: torch.Tensor        # [B, T] scaled rewards
    slo_ok: torch.Tensor        # [B, T]
    last_value: torch.Tensor    # [B] bootstrap value at the window edge
    env_states: ClusterState    # the worlds after the window
    steps: ExogenousTrace       # [B, T, ...] the collect ticks' signals
    world_seed: int
    violation_weight: float     # the price the rewards were computed at


def _gaussian_logp(u, mean, log_std):
    var = torch.exp(2.0 * log_std)
    return (-0.5 * ((u - mean) ** 2 / var + 2.0 * log_std
                    + math.log(2.0 * math.pi))).sum(dim=-1)


def _is_actor(name: str) -> bool:
    return name.startswith("actor_mean.") or name == "log_std"


class PPOTrainer:
    """Builds and drives the PPO iteration.

    ``anchor_params``: optional frozen ActorCritic params (a state dict or
    the flax-layout tree) defining a trust region: with
    ``train.anchor_coef > 0`` the loss carries a ||mean - anchor_mean||^2
    penalty toward the anchor's action means. The flagship driver passes
    the distilled teacher init here so refinement explores around it.
    """

    def __init__(self, cfg: FrameworkConfig, *, anchor_params=None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cluster = cfg.cluster
        self.tcfg = cfg.train
        self.params_sim = SimParams.from_config(cfg, device=self.device)
        self.act_dim = latent_dim(cfg.cluster)
        b0 = initial_state(cfg, 1, self.device)
        self.obs_dim = self._obs(b0, self._dummy_exo(1)).shape[-1]
        self.net = ActorCritic(self.obs_dim, self.act_dim,
                               init_log_std=self.tcfg.init_log_std
                               ).to(self.device)
        self.anchor_params = (None if anchor_params is None
                              else self.as_state_dict(anchor_params))
        lr = self.tcfg.learning_rate
        if self.tcfg.lr_decay_iters > 0:
            # One optimizer step per epoch per iteration.
            lr = cosine_decay_schedule(
                lr, self.tcfg.lr_decay_iters * self.tcfg.ppo_epochs,
                alpha=0.05)
        self.opt = Chain(lr, max_norm=1.0)

    # -- params ---------------------------------------------------------------

    def as_state_dict(self, params) -> dict:
        """Params as this trainer's state dict on its device: a state dict
        passes through, a flax-layout tree (``{"params": ...}``) is
        bridged."""
        if "params" in params:
            params = bridge.actor_critic_from_flax(params)
        return {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in params.items()}

    def apply(self, params: dict, obs: torch.Tensor):
        """``(mean, log_std, value)`` of the net at ``params`` on [N, F]
        observations."""
        return functional_call(self.net, params, (obs,))

    # -- initialization -------------------------------------------------------

    def init_state(self, seed: int | None = None) -> PPOTrainState:
        """Fresh params (flax's initialisation, from a CPU generator
        seeded with ``seed``, so they do not depend on the device), fresh
        optimizer moments, ``batch_clusters`` fresh worlds and the
        generator of the run's draws."""
        seed = self.tcfg.seed if seed is None else seed
        init = ActorCritic(self.obs_dim, self.act_dim,
                           init_log_std=self.tcfg.init_log_std,
                           generator=torch.Generator().manual_seed(seed))
        params = {k: v.detach().to(self.device)
                  for k, v in init.state_dict().items()}
        return self.fresh_state(params, seed)

    def fresh_state(self, params, seed: int | None = None) -> PPOTrainState:
        """A train state at ``params`` with fresh optimizer moments."""
        seed = self.tcfg.seed if seed is None else seed
        params = self.as_state_dict(params)
        return PPOTrainState(
            params=params,
            opt_state=self.opt.init(list(params.values())),
            env_states=initial_state(self.cfg, self.tcfg.batch_clusters,
                                     self.device),
            generator=torch.Generator(device=self.device).manual_seed(
                seed + 1),
            iteration=0,
            violation_weight=float(self.tcfg.slo_violation_weight))

    def _dummy_exo(self, b: int) -> ExoStep:
        z = self.cluster.n_zones

        def zeros(*shape):
            return torch.zeros((b, *shape), device=self.device)

        return ExoStep(spot_price_hr=zeros(z), od_price_hr=zeros(z),
                       carbon_g_kwh=zeros(z), demand_pods=zeros(2),
                       is_peak=zeros())

    def _obs(self, states: ClusterState, exo: ExoStep) -> torch.Tensor:
        return observe(self.params_sim, states, exo).flatten()

    # -- one PPO iteration: collect, then update ------------------------------

    def _price(self, ts: PPOTrainState) -> float:
        return (ts.violation_weight if self.tcfg.attain_target > 0
                else float(self.tcfg.slo_violation_weight))

    @torch.no_grad()
    def collect(self, ts: PPOTrainState, window: ExogenousTrace,
                noise: torch.Tensor | None = None) -> PPOBuffers:
        """Roll the worlds through ``window`` ([B, T+1, ...]: T collect
        ticks and one lookahead tick for the bootstrap observation) under
        the stochastic policy. ``noise`` ([B, T, A] standard normals, the
        action noise of every tick) defaults to draws from the state's
        generator; the window's world seed is drawn from it first."""
        T = window.steps - 1
        world_seed = int(torch.randint(_WORLD_SEEDS, (1,),
                                       generator=ts.generator,
                                       device=self.device))
        vw = self._price(ts)
        rec: dict = {"obs": [], "u": [], "logp": [], "value": []}

        def decide(state, exo, t):
            obs = self._obs(state, exo)
            mean, log_std, value = self.apply(ts.params, obs)
            eps = (noise[:, t] if noise is not None else torch.randn(
                mean.shape, generator=ts.generator, device=self.device))
            u = mean + torch.exp(log_std) * eps
            for k, v in (("obs", obs), ("u", u), ("value", value),
                         ("logp", _gaussian_logp(u, mean, log_std))):
                rec[k].append(v)
            return latent_to_action(u, self.cluster)

        steps = window.slice_steps(0, T)
        env_states, metrics = rollout(self.params_sim, ts.env_states, decide,
                                      steps, world_seed, stochastic=True)
        # Bootstrap value at the window edge: the post-step worlds with the
        # NEXT tick's signals, the observation the policy sees at T.
        boot = ExoStep(*(x[:, T] for x in exo_steps(window)))
        _, _, last_value = self.apply(ts.params, self._obs(env_states, boot))
        stacked = {k: torch.stack(v, dim=1) for k, v in rec.items()}
        return PPOBuffers(
            reward=step_reward(metrics, self.tcfg, vw) * _REWARD_SCALE,
            slo_ok=metrics.slo_ok, last_value=last_value,
            env_states=env_states, steps=steps, world_seed=world_seed,
            violation_weight=vw, **stacked)

    def advantages(self, buf: PPOBuffers):
        """GAE over the time axis: ``(normalized advantages, returns)``,
        both [B, T]. Advantages are normalized over the whole window
        (standard deviation with ddof 0, as `jnp.std`) and clipped at
        ``adv_clip`` sigmas when set."""
        tcfg = self.tcfg
        T = buf.reward.shape[1]
        gae = torch.zeros_like(buf.last_value)
        next_value = buf.last_value
        adv = [None] * T
        for t in reversed(range(T)):
            delta = (buf.reward[:, t] + tcfg.gamma * next_value
                     - buf.value[:, t])
            gae = delta + tcfg.gamma * tcfg.gae_lambda * gae
            adv[t] = gae
            next_value = buf.value[:, t]
        adv = torch.stack(adv, dim=1)
        returns = adv + buf.value
        adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        if tcfg.adv_clip > 0:
            # One violation-spike tick contributes at most adv_clip sigmas
            # to the policy gradient (the critic still sees it through
            # the returns).
            adv = clip(adv, -tcfg.adv_clip, tcfg.adv_clip)
        return adv, returns

    def update(self, ts: PPOTrainState, buf: PPOBuffers):
        """The clipped-surrogate epochs over ``buf``; returns
        ``(new_state, diagnostics)``."""
        tcfg = self.tcfg
        adv, returns = self.advantages(buf)
        obs_f = buf.obs.reshape(-1, buf.obs.shape[-1])
        u_f = buf.u.reshape(-1, buf.u.shape[-1])
        logp_f, adv_f, ret_f = (x.reshape(-1) for x in (buf.logp, adv,
                                                        returns))
        # Critic-first warmup: no policy-gradient or entropy term while
        # iteration < critic_warmup_iters.
        policy_coef = 0.0 if ts.iteration < tcfg.critic_warmup_iters else 1.0
        anchor_mean = None
        if self.anchor_params is not None and tcfg.anchor_coef > 0:
            with torch.no_grad():
                anchor_mean = self.apply(self.anchor_params, obs_f)[0]
        names = list(ts.params)

        def loss_fn(p: dict):
            mean, log_std, value = self.apply(p, obs_f)
            logp = _gaussian_logp(u_f, mean, log_std)
            ratio = torch.exp(logp - logp_f)
            clipped = clip(ratio, 1.0 - tcfg.ppo_clip, 1.0 + tcfg.ppo_clip)
            policy_loss = -torch.minimum(ratio * adv_f,
                                         clipped * adv_f).mean()
            value_loss = ((value - ret_f) ** 2).mean()
            entropy = (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum()
            total = (policy_coef * policy_loss
                     + tcfg.value_coef * value_loss
                     - policy_coef * tcfg.entropy_coef * entropy)
            if anchor_mean is not None:
                # Not gated by policy_coef: the anchor also pins the actor
                # against drift through the shared torso during warm-up.
                total = total + tcfg.anchor_coef * (
                    (mean - anchor_mean) ** 2).mean()
            kl = (logp_f - logp).mean()
            return total, (policy_loss, value_loss, entropy, kl)

        params, opt_state = ts.params, ts.opt_state
        for _ in range(tcfg.ppo_epochs):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in params.items()}
                total, aux = loss_fn(leaves)
                grads = torch.autograd.grad(total, list(leaves.values()))
            aux = tuple(x.detach() for x in aux)
            # Target-KL early stop: once the KL passes the target, this and
            # the remaining epochs apply no update and keep the optimizer
            # state (their losses, at the same params, are this epoch's).
            # Off during critic warm-up.
            if float(aux[3]) > tcfg.ppo_target_kl and policy_coef > 0:
                break
            updates, opt_state = self.opt.update(list(grads), opt_state)
            params = {
                k: params[k] + (u * tcfg.actor_lr_scale if _is_actor(k)
                                and tcfg.actor_lr_scale != 1.0 else u)
                for k, u in zip(names, updates)}
        p_loss, v_loss, entropy, kl = aux

        # Multiplier adaptation (dual ascent on the attainment constraint),
        # measured on a deterministic (mean-action) shadow rollout of the
        # same window with the new params: the scoreboard scores the mean
        # policy, and the stochastic batch's attainment sits far below it.
        attain = buf.slo_ok.mean()
        new_vw = ts.violation_weight
        if tcfg.attain_target > 0:
            attain = self.shadow_attainment(params, ts.env_states, buf.steps,
                                            buf.world_seed + _SHADOW_SEED)
            new_vw = min(max(buf.violation_weight * math.exp(
                tcfg.lagrange_lr * (tcfg.attain_target - float(attain))),
                tcfg.lagrange_min), tcfg.lagrange_max)
        new_ts = ts._replace(params=params, opt_state=opt_state,
                             env_states=buf.env_states,
                             iteration=ts.iteration + 1,
                             violation_weight=new_vw)
        diag = PPODiagnostics(
            mean_reward=buf.reward.mean() / _REWARD_SCALE,
            policy_loss=p_loss, value_loss=v_loss, entropy=entropy,
            approx_kl=kl, attainment=attain,
            violation_weight=torch.tensor(buf.violation_weight))
        return new_ts, diag

    @torch.no_grad()
    def shadow_attainment(self, params: dict, env_states: ClusterState,
                          steps: ExogenousTrace, seed: int) -> torch.Tensor:
        """Mean SLO attainment of the mean-action policy at ``params``
        from ``env_states`` over ``steps``, stochastic worlds of ``seed``."""
        _, metrics = rollout(
            self.params_sim, env_states,
            lambda s, e, t: latent_to_action(
                self.apply(params, self._obs(s, e))[0], self.cluster),
            steps, seed, stochastic=True)
        return metrics.slo_ok.mean()

    def iteration(self, ts: PPOTrainState, window: ExogenousTrace,
                  noise: torch.Tensor | None = None):
        """One PPO iteration: ``update(ts, collect(ts, window, noise))``."""
        return self.update(ts, self.collect(ts, window, noise))

    # -- host-side driver -----------------------------------------------------

    def make_windows(self, source, iterations: int, *,
                     seed: int = 0) -> ExogenousTrace:
        """[B, iterations * unroll_steps + 1, ...] per-cluster traces (each
        iteration reads unroll_steps ticks plus one lookahead tick; windows
        overlap by one). With ``train.device_traces`` and a synthesizing
        source the batch is made on the device from a generator seeded
        with ``seed``; otherwise from numpy seeds ``seed .. seed + B - 1``."""
        b = self.tcfg.batch_clusters
        total = iterations * self.tcfg.unroll_steps + 1
        if self.tcfg.device_traces and hasattr(source, "batch_trace_device"):
            return source.batch_trace_device(
                total, torch.Generator(device=self.device).manual_seed(seed),
                b, device=self.device)
        return source.batch_trace(total, range(seed, seed + b),
                                  device=self.device)

    def train(self, source, iterations: int, *, seed: int | None = None,
              log_every: int = 0,
              runlog=None) -> tuple[PPOTrainState, list[dict]]:
        """``iterations`` iterations from :meth:`init_state`. ``runlog``
        (an `obs.runlog.RunLog`) gets each history record as an "iter"
        event."""
        ts = self.init_state(seed)
        seed = self.tcfg.seed if seed is None else seed
        all_traces = self.make_windows(source, iterations, seed=seed + 1000)
        t_len = self.tcfg.unroll_steps
        history = []
        for it in range(iterations):
            window = all_traces.slice_steps(it * t_len, t_len + 1)
            ts, diag = self.iteration(ts, window)
            if log_every and (it % log_every == 0 or it == iterations - 1):
                rec = {k: float(v) for k, v in diag._asdict().items()}
                rec["iteration"] = it
                history.append(rec)
                if runlog is not None:
                    runlog.event("iter", **rec)
        return ts, history


class PPOBackend(PolicyBackend):
    """Deterministic (mean-action) policy from trained PPO params.

    ``params`` is the ActorCritic params tree in the checkpoints' layout
    (`bridge.actor_critic_from_flax`); it stays available as
    ``self.params`` for the rollout kernel's entries, which take the tree.
    """

    def __init__(self, cfg: FrameworkConfig, params: dict, device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.cluster = cfg.cluster
        self.params_sim = SimParams.from_config(cfg, device=dev)
        self.params = params
        state = bridge.actor_critic_from_flax(params)
        hidden = [state[f"Dense_{i}.bias"].shape[-1]
                  for i in range(sum(k.startswith("Dense_")
                                     and k.endswith(".bias") for k in state))]
        self.net = ActorCritic(state["Dense_0.weight"].shape[-1],
                               latent_dim(cfg.cluster), hidden)
        self.net.load_state_dict(state)
        self.net.to(dev).requires_grad_(False)

    def decide(self, state: ClusterState, exo: ExoStep, t: int) -> Action:
        """Batch-first: a cluster's action is the same whether it is
        decided alone or in a fleet (`models.nets.rowwise_policy_mean`)."""
        obs = observe(self.params_sim, state, exo).flatten()
        return latent_to_action(rowwise_policy_mean(self.net, obs),
                                self.cluster)


def ppo_train(cfg: FrameworkConfig, source, iterations: int, *,
              seed: int | None = None, log_every: int = 10,
              device=None) -> tuple[PPOBackend, list[dict]]:
    """Train and wrap the deterministic backend."""
    trainer = PPOTrainer(cfg, device=device)
    ts, history = trainer.train(source, iterations, seed=seed,
                                log_every=log_every)
    return PPOBackend(cfg, bridge.actor_critic_to_flax(ts.params),
                      device=trainer.device), history
