"""(1+lambda)-ES refinement: episodic direct policy search around a
distilled init.

The PyTorch form of `ccka_tpu/train/cem.py`. The scoreboard is a
lexicographic criterion over full-episode KPIs, which a per-tick reward
distorts, so this searches the episode criterion directly:

- **(1+lambda) hill climb**: the incumbent competes in every generation
  on the same fresh traces and world randomness as its lambda
  perturbations, and moves only when one measurably beats it;
- **actor-head-only perturbation** (default), with the hpa coordinates'
  noise damped (``hpa_damp``): the serve-demand operating point sits 1 %
  above the SLO cliff;
- **1/5-rule sigma adaptation** inside ``[sigma_min, sigma_max]``;
- fitness = the selection criterion itself (worst headline ratio against
  the bars plus an attainment-shortfall penalty) on fresh full-day
  stochastic traces every generation.

Two engines, both paired (candidates, rule and teacher see the same
worlds and the same interruption draws):

- ``"lax"``: the plain batched rollout (`sim/rollout.py`), one per
  candidate over the generation's traces, and the rule and teacher on
  the same traces and world seed;
- ``"mega"``: every rollout of a generation on the rollout kernels: one
  packed stream and one Philox seed shared by the rule, carbon and
  population launches (`sim/megakernel.py`: ``traces_per_gen`` must be a
  multiple of 128; the whole population is one MLP launch). The stream
  buffer is synthesized into again every generation, so back-to-back
  generations hold one stream on the card. On the CPU the entries run
  their plain versions. With ``mesh=`` (`parallel/mesh.py`) the
  generation's traces split over the mesh's data shards: shard ``i``
  synthesizes its lane block on its device
  (`parallel/sharded_kernel.py::sharded_packed_trace`) and runs the
  three launches there with its first trace's global index, so the
  generation is bitwise a single-device generation on the concatenated
  shard streams (``traces_per_gen / shards`` a multiple of 128).

Draws: each generation's traces or stream, its world seed and its
perturbation noise [popsize - 1, dim] come from a generator seeded with
``seed``; ``draws=`` supplies them instead. The flat parameter layout is
the JAX package's (``jax.tree_util`` order: dict keys sorted, leaves
raveled row-major, flax's [in, out] kernels), so a noise matrix means the
same in both.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import FrameworkConfig
from ccka_tpu_torch.models import latent_dim
from ccka_tpu_torch.policy.carbon import CarbonAwarePolicy
from ccka_tpu_torch.policy.rule import RulePolicy, offpeak_action, peak_action
from ccka_tpu_torch.sim.rollout import batched_rollout_summary, initial_state
from ccka_tpu_torch.sim.types import SimParams

_WORLD_SEEDS = 2 ** 30


class CEMConfig(NamedTuple):
    generations: int = 40
    popsize: int = 32          # 1 incumbent + (popsize-1) perturbations
    sigma0: float = 5e-3       # perturbation std (actor-head weight units)
    sigma_grow: float = 1.3
    sigma_shrink: float = 0.85
    # Absolute step-size envelope (not relative to sigma0): chunked
    # callers carry the annealed sigma into the next chunk's sigma0.
    sigma_min: float = 5e-3 / 16.0
    sigma_max: float = 2e-2
    head_only: bool = True     # perturb actor_mean only
    traces_per_gen: int = 4
    eval_steps: int = 2880     # full day: shorter windows miss peak hours
    attain_penalty: float = 25.0
    # Per-axis bars when a teacher is paired: "min" (beat the tighter of
    # rule and teacher per axis), "rule" or "teacher"; attain_bar "max"
    # (the higher), "rule" or "teacher".
    usd_bar: str = "min"
    co2_bar: str = "min"
    attain_bar: str = "max"
    # Added to the attainment bar, so the selected operating point keeps
    # clear of the bar on fresh data.
    attain_margin: float = 0.0
    # Scale on the hpa latent coordinates' perturbation (the last C
    # columns of actor_mean): the anisotropic trust region.
    hpa_damp: float = 0.25


class CEMDraws(NamedTuple):
    """One generation's randomness: the traces ([G, T, ...], lax engine)
    or packed stream ([T_pad, rows, G], mega engine), the world seed of
    the interruption draws and the perturbation noise [popsize - 1, dim]."""

    worlds: object
    world_seed: int
    noise: torch.Tensor


def _leaves(params: dict, prefix: tuple = ()):
    """``(path, leaf)`` in ``jax.tree_util`` order: dict keys sorted."""
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flatten(params: dict, device=None) -> tuple[torch.Tensor, list]:
    """A params tree -> (flat float32 vector, spec) in the JAX package's
    leaf order."""
    paths, flats, shapes = [], [], []
    for path, leaf in _leaves(params):
        x = torch.as_tensor(np.asarray(leaf, np.float32) if not isinstance(
            leaf, torch.Tensor) else leaf, dtype=torch.float32)
        paths.append(path)
        shapes.append(tuple(x.shape))
        flats.append(x.reshape(-1).to(device or x.device))
    return torch.cat(flats), list(zip(paths, shapes))


def _unflatten(flat: torch.Tensor, spec) -> dict:
    """Inverse of :func:`_flatten`; a leading axis of ``flat`` ([N, dim])
    becomes a leading axis of every leaf."""
    lead = flat.shape[:-1]
    out: dict = {}
    off = 0
    for path, shape in spec:
        n = int(np.prod(shape)) if shape else 1
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[..., off:off + n].reshape(*lead, *shape)
        off += n
    return out


def _head_mask(params: dict, coord_scale: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Per-weight perturbation scale, flat layout: 1.0 on actor_mean
    leaves, 0.0 elsewhere. ``coord_scale`` ([A]) additionally scales the
    head's output coordinates (kernel columns and bias entries)."""
    parts = []
    for path, leaf in _leaves(params):
        shape = tuple(np.shape(leaf))
        if "actor_mean" in path and coord_scale is not None:
            block = (coord_scale[None, :].expand(shape) if len(shape) == 2
                     else coord_scale)
            parts.append(block.reshape(-1).to(torch.float32))
            continue
        on = 1.0 if "actor_mean" in path else 0.0
        parts.append(torch.full((int(np.prod(shape)) or 1,), on))
    return torch.cat(parts)


def perturbation_mask(params: dict, cem: CEMConfig, cluster,
                      device=None) -> torch.Tensor:
    """The flat per-weight perturbation scale of a CEM run: the actor head
    (with its hpa coordinates damped by ``hpa_damp``) under ``head_only``,
    else every weight."""
    if not cem.head_only:
        return torch.ones(_flatten(params)[0].shape[0], device=device)
    coord_scale = None
    if cem.hpa_damp != 1.0:
        cs = np.ones(latent_dim(cluster), np.float32)
        cs[-2:] = cem.hpa_damp   # hpa coords are the codec's last C
        coord_scale = torch.from_numpy(cs)
    return _head_mask(params, coord_scale).to(device)


def candidates(incumbent: torch.Tensor, sigma: torch.Tensor,
               noise: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A generation's population [popsize, dim]: candidate 0 IS the
    incumbent (paired with its challengers on identical worlds), the rest
    ``incumbent + sigma * noise * mask``, as float32 operations in the
    JAX engine's order."""
    return torch.cat([incumbent[None, :],
                      incumbent[None, :] + sigma * noise * mask[None, :]],
                     dim=0)


def _numpy_tree(tree: dict) -> dict:
    return {k: (_numpy_tree(v) if isinstance(v, dict)
                else v.detach().cpu().numpy()) for k, v in tree.items()}


def _fields(summary, names=("usd_per_slo_hour", "g_co2_per_kreq",
                            "slo_attainment")):
    """The headline fields of a summary as float32 numpy arrays."""
    return [np.asarray(getattr(summary, f).detach().cpu(), np.float32)
            for f in names]


def cem_refine(cfg: FrameworkConfig, params0, source, *,
               cem: CEMConfig | None = None, bars: dict | None = None,
               teacher_fn=None, teacher_policy=None, engine: str = "lax",
               mesh=None, seed: int = 0,
               draws: Callable[[int], CEMDraws] | None = None,
               log=None, runlog=None,
               device=None) -> tuple[dict, list[dict], dict]:
    """Refine ``params0`` (an ActorCritic params tree, the flax layout) by
    (1+lambda) episodic search; returns ``(best_params, history, info)``,
    the params a tree of numpy arrays.

    ``bars``: absolute KPI levels to beat ``{"usd", "co2", "attain"}``;
    fitness is ``max(usd / bars.usd, co2 / bars.co2) + penalty *
    max(0, bars.attain + margin - attain)`` averaged over the traces,
    paired against the rule and re-anchored to the bars. ``teacher_fn``
    (an action_fn, lax engine) or ``teacher_policy`` (a rule or carbon
    PolicyBackend, either engine) pairs the bars per generation instead:
    min(rule, teacher) per axis on the generation's own traces, by
    ``CEMConfig.usd_bar`` / ``co2_bar`` / ``attain_bar``.

    ``engine``: ``"lax"`` or ``"mega"`` (module docstring). ``mesh``
    (mega engine) splits each generation's traces over the mesh's data
    shards; ignored by the lax engine. ``draws(generation)`` returns a
    :class:`CEMDraws` in place of the generator's (with a mesh, its
    stream is split over the shards).
    ``runlog`` (an `obs.runlog.RunLog`) gets every history record as a
    "gen" event.

    ``info`` carries the returned candidate's provenance (``gen``: the
    last generation that improved the incumbent, 0 if none did;
    ``fitness``) and ``final_sigma`` so chunked callers continue the
    annealing schedule."""
    dev = resolve_device(device)
    cem = cem or CEMConfig()
    log = log or (lambda s: None)
    n_teachers = (teacher_fn is not None) + (teacher_policy is not None)
    if bars is not None and n_teachers:
        raise ValueError("pass bars OR a teacher, not both: with a teacher "
                         "the bars are paired per generation and absolute "
                         "bars would be silently ignored")
    if n_teachers > 1:
        raise ValueError("pass teacher_fn (lax) or teacher_policy "
                         "(mega), not both")
    if engine not in ("lax", "mega"):
        raise ValueError(f"unknown engine {engine!r}")
    for field, allowed in (("usd_bar", ("min", "rule", "teacher")),
                           ("co2_bar", ("min", "rule", "teacher")),
                           ("attain_bar", ("max", "rule", "teacher"))):
        if getattr(cem, field) not in allowed:
            raise ValueError(f"CEMConfig.{field} must be one of "
                             f"{allowed}, got {getattr(cem, field)!r}")
    if engine == "mega":
        if teacher_fn is not None:
            raise ValueError("engine='mega' takes teacher_policy, not "
                             "teacher_fn (the kernel must recognize the "
                             "policy family)")
        if draws is None and not hasattr(source, "packed_trace_device"):
            raise ValueError("engine='mega' needs a device-synthesizing "
                             "source (packed_trace_device)")
        _check_mega_batch(cem.traces_per_gen, mesh, source, draws)
        if teacher_policy is not None and not isinstance(
                teacher_policy, (CarbonAwarePolicy, RulePolicy)):
            raise ValueError("mega engine fuses rule/carbon teachers "
                             f"only, got {type(teacher_policy).__name__}")
    elif teacher_policy is not None:
        teacher_fn = teacher_policy.action_fn()
    has_teacher = n_teachers > 0
    params_sim = SimParams.from_config(cfg, device=dev)

    flat0, spec = _flatten(params0, dev)
    dim = flat0.shape[0]
    mask = perturbation_mask(params0, cem, cfg.cluster, dev)
    n_pert = cem.popsize - 1
    G, T = cem.traces_per_gen, cem.eval_steps

    if engine == "lax":
        from ccka_tpu_torch.train.ppo import PPOBackend

        rule_fn = RulePolicy(cfg.cluster, device=dev).action_fn()

        def summary(action_fn, traces, world_seed):
            states0 = initial_state(cfg, traces.is_peak.shape[0], dev)
            return batched_rollout_summary(params_sim, states0, action_fn,
                                           traces, world_seed,
                                           stochastic=True)[1]

        @torch.no_grad()
        def generation(cand, traces, world_seed):
            members = [summary(PPOBackend(
                cfg, _numpy_tree(_unflatten(c, spec)), device=dev
            ).action_fn(), traces, world_seed) for c in cand]
            pop = type(members[0])(*(torch.stack(xs) for xs in
                                     zip(*members)))
            rule_s = summary(rule_fn, traces, world_seed)
            teach_s = (summary(teacher_fn, traces, world_seed)
                       if teacher_fn is not None else rule_s)
            return pop, rule_s, teach_s
    else:
        generation = _mega_generation(cfg, params_sim, teacher_policy,
                                      spec, T, mesh, dev)

    gen_rng = torch.Generator(device=dev).manual_seed(seed)
    stream_buf = None   # the mega engine's stream, written over each time

    def own_draws(gen: int) -> CEMDraws:
        nonlocal stream_buf
        draw = lambda: int(torch.randint(  # noqa: E731
            _WORLD_SEEDS, (1,), generator=gen_rng, device=dev))
        if engine == "mega" and mesh is not None:
            from ccka_tpu_torch.parallel.sharded_kernel import (
                sharded_packed_trace)

            stream_buf = sharded_packed_trace(mesh, source, T, draw(), G,
                                              recycle=stream_buf)
            worlds = stream_buf
        elif engine == "mega":
            stream_buf = source.packed_trace_device(
                T, draw(), G, out=stream_buf, device=dev)
            worlds = stream_buf
        elif hasattr(source, "batch_trace_device"):
            worlds = source.batch_trace_device(T, gen_rng, G, device=dev)
        else:
            s0 = draw()
            worlds = source.batch_trace(T, range(s0, s0 + G), device=dev)
        return CEMDraws(worlds, draw(), torch.randn(
            (n_pert, dim), generator=gen_rng, device=dev))

    history: list[dict] = []
    incumbent = flat0
    sigma = float(cem.sigma0)
    info = {"gen": 0, "fitness": float("inf")}
    for gen in range(cem.generations):
        d = draws(gen) if draws is not None else own_draws(gen)
        worlds = d.worlds
        if engine == "mega" and not hasattr(worlds, "parts"):
            worlds = torch.as_tensor(worlds).to(dev)
        elif engine != "mega":
            worlds = worlds.to(dev)
        noise = torch.as_tensor(d.noise, dtype=torch.float32).to(dev)
        cand = candidates(incumbent, torch.tensor(
            sigma, dtype=torch.float32, device=dev), noise, mask)
        summaries, rule_s, teach_s = generation(cand, worlds,
                                                int(d.world_seed))

        usd, co2, attain = _fields(summaries)                 # [pop, G]
        rule_usd, rule_co2, rule_att = (x[None, :] for x in _fields(rule_s))
        if has_teacher:
            def bar(rule_v, teach_v, mode):
                if mode == "rule":
                    return rule_v
                if mode == "teacher":
                    return teach_v
                return np.minimum(rule_v, teach_v)

            teach_usd, teach_co2, teach_att = (x[None, :] for x in
                                               _fields(teach_s))
            usd_bar = bar(rule_usd, teach_usd, cem.usd_bar)
            co2_bar = bar(rule_co2, teach_co2, cem.co2_bar)
            if cem.attain_bar == "rule":
                attain_bar = float(rule_att[0].mean())
            elif cem.attain_bar == "teacher":
                attain_bar = float(teach_att[0].mean())
            else:
                attain_bar = float(np.maximum(rule_att[0],
                                              teach_att[0]).mean())
            usd_ratio = (usd / usd_bar).mean(axis=1)
            co2_ratio = (co2 / co2_bar).mean(axis=1)
        else:
            if bars:
                # Paired against the rule, re-anchored to the bars.
                usd_scale = float(rule_usd.mean()) / float(bars["usd"])
                co2_scale = float(rule_co2.mean()) / float(bars["co2"])
                attain_bar = float(bars["attain"])
            else:
                usd_scale = co2_scale = 1.0
                attain_bar = float(rule_att[0].mean())
            usd_ratio = (usd / rule_usd).mean(axis=1) * usd_scale
            co2_ratio = (co2 / rule_co2).mean(axis=1) * co2_scale
        shortfall = np.maximum(attain_bar + cem.attain_margin
                               - attain.mean(axis=1), 0.0)
        fitness = (np.maximum(usd_ratio, co2_ratio)
                   + cem.attain_penalty * shortfall)          # [pop]

        gi = int(np.argmin(fitness))
        improved = gi != 0 and fitness[gi] < fitness[0]
        if improved:
            incumbent = cand[gi].clone()
            info = {"gen": gen + 1, "fitness": float(fitness[gi])}
            sigma = min(sigma * cem.sigma_grow, cem.sigma_max)
        else:
            if np.isfinite(fitness[0]):
                info = {"gen": info["gen"], "fitness": float(fitness[0])}
            sigma = max(sigma * cem.sigma_shrink, cem.sigma_min)

        rec = {
            "generation": gen,
            "improved": bool(improved),
            "incumbent_fitness": float(fitness[0]),
            "best_fitness": float(fitness[gi]),
            "best_usd_ratio": float(usd_ratio[gi]),
            "best_co2_ratio": float(co2_ratio[gi]),
            "best_attain": float(attain[gi].mean()),
            "frac_broken": float(np.mean(fitness > 10.0)),
            "sigma": sigma,
        }
        history.append(rec)
        if runlog is not None:
            runlog.event("gen", **rec)
        log(f"gen {gen:3d}: incumbent {rec['incumbent_fitness']:.4f} "
            f"best {rec['best_fitness']:.4f} "
            f"(usd x{rec['best_usd_ratio']:.3f} "
            f"co2 x{rec['best_co2_ratio']:.3f} "
            f"attain {rec['best_attain']:.4f})"
            f"{' IMPROVED' if improved else ''} "
            f"sigma {sigma:.4f} broken {rec['frac_broken']:.2f}")

    info = dict(info, final_sigma=sigma)
    return _numpy_tree(_unflatten(incumbent, spec)), history, info


def _check_mega_batch(G: int, mesh, source, draws) -> None:
    """The mega engine's batch checks (the JAX package's messages): a
    multiple of 128 traces, of 128 per shard on a mesh, whose shards
    synthesize their own streams unless ``draws`` supplies them."""
    if mesh is None:
        if G % 128:
            raise ValueError("mega engine needs traces_per_gen to be a "
                             f"multiple of 128, got {G}")
        return
    from ccka_tpu_torch.parallel.mesh import data_shards

    n_shards = data_shards(mesh)
    if G % n_shards:
        raise ValueError(f"mega engine on a {n_shards}-shard mesh "
                         f"needs traces_per_gen divisible by the "
                         f"data-axis size, got {G}")
    if draws is None and not hasattr(source, "packed_generate_fn"):
        raise ValueError(
            "mesh mega engine needs a shard-locally synthesizing "
            "source (packed_generate_fn) — replay stores are "
            "host-resident and cannot generate per shard")
    if (G // n_shards) % 128:
        raise ValueError(
            f"mega engine on a {n_shards}-shard mesh needs "
            f"traces_per_gen/shard to be a multiple of 128, got "
            f"{G // n_shards} (= {G}/{n_shards})")


def _mega_generation(cfg: FrameworkConfig, params_sim: SimParams,
                     teacher_policy, spec, T: int, mesh, dev):
    """``generation(cand, stream, world_seed) -> (population, rule,
    teacher summaries)`` on the kernels: the rule, carbon and population
    launches share the stream and the seed, so the worlds and the
    interruption draws are identical per (trace, tick) for every
    candidate and both bars. On a mesh every shard runs the three
    launches on its lane block (the summaries gathered on ``dev``)."""
    from ccka_tpu_torch.parallel import sharded_kernel as sk
    from ccka_tpu_torch.parallel.mesh import gather
    from ccka_tpu_torch.sim import megakernel as mk

    off_a, peak_a = offpeak_action(cfg.cluster, dev), peak_action(
        cfg.cluster, dev)
    tkw = (dict(sharpness=teacher_policy.sharpness,
                min_weight=teacher_policy.min_weight,
                stickiness=teacher_policy.stickiness)
           if isinstance(teacher_policy, CarbonAwarePolicy) else None)
    if mesh is None:
        rule, carbon, neural = (mk.megakernel_summary_from_packed,
                                mk.carbon_megakernel_summary_from_packed,
                                mk.neural_megakernel_summary_from_packed)
    else:
        def on_mesh(entry):
            return lambda *a, **k: gather(entry(mesh, *a, **k), dev)

        rule, carbon, neural = (
            on_mesh(sk.sharded_megakernel_summary_from_packed),
            on_mesh(sk.sharded_carbon_summary_from_packed),
            on_mesh(sk.sharded_neural_summary_from_packed))

    @torch.no_grad()
    def generation(cand, stream, world_seed):
        rule_s = rule(params_sim, off_a, peak_a, stream, T, world_seed)
        teach_s = (carbon(params_sim, off_a, peak_a, stream, T, world_seed,
                          **tkw) if tkw else rule_s)
        pop = neural(params_sim, cfg.cluster, _unflatten(cand, spec),
                     stream, T, world_seed)
        return pop, rule_s, teach_s

    return generation
