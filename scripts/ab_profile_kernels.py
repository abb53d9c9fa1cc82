"""Time the profile rollout kernels of two checkouts on one card, in turns.

    git archive <commit> | tar -x -C _checkout/parent   # .gitignore lists it
    python3 scripts/ab_profile_kernels.py --parent _checkout/parent

Builds the CUDA sources of the parent checkout and of this one, each with
its own `ccka_tpu_torch/kernels/build.py`, afresh into a directory under
--out (so that nvcc prints every function's registers and spill), makes
every input once with this checkout's package (streams and plans from
seeds), and times each case through each checkout's launch wrappers as
the median of --reps launches after a warm-up, in the order parent, this,
this, parent. The cases:

- the default preset's rule kernel at B = 8192 ... 65536 x T = 2880, both
  modes (the fleet-size sweep; B = 32768 stochastic is the rule path);
- the multiregion rule, carbon and plan kernels at B = 32768 x T = 2880,
  both modes, on a plain stream (a random decoded plan per cluster);
- the same three, stochastic, on the severe (fault lanes) and mixed
  (fault and workload lanes) streams, and on mixed a day of 8 CARRY
  launches of 360 ticks;
- the MLP kernel (the shipped multiregion flagship), stochastic.

Each case's line says whether this checkout's output is bitwise the
parent's. --out receives, per checkout, every kernel function's ptxas
registers, stack and spill and its SASS counts
(`kernels/build.py::sass_counts`), and the cases as JSON. Needs a CUDA
device and nvcc; runs no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

T_DAY = 2880
B_MAIN = 32768
SWEEP = (8192, 16384, 32768, 65536)
CARBON = (10.0, 0.05, 1.0)  # CarbonAwarePolicy's defaults
BLOCK = 360                 # a CARRY day in 8 launches
STATE_ROWS = 128            # at least every CARRY instantiation's rows


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def load_build(root: Path, tag: str, build_dir: Path):
    """A checkout's kernels/build.py as a module of its own name, reading
    that checkout's csrc/ and building into ``build_dir``."""
    path = root / "ccka_tpu_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(f"build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BUILD_DIR = build_dir
    return mod


def build_report(mod) -> dict:
    """Every kernel function's ptxas registers, stack and spill and its
    SASS counts, keyed "source|faults|D|function"."""
    from ccka_tpu_torch.kernels.build import sass_counts

    report: dict = {}
    for unit, (lib, text, _) in mod.build_all().items():
        prefix = "|".join(map(str, unit))
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = report.setdefault(f"{prefix}|{m.group(1)}", {})
            elif fn is not None and "Used" in line and "registers" in line:
                fn["registers"] = int(line.split("Used")[1].split()[0])
            elif fn is not None and "spill stores" in line:
                stack, st, ld = map(int, re.findall(r"(\d+) bytes", line))
                fn.update(stack=stack, spill_stores=st, spill_loads=ld)
        mod.library(*unit)
        cuobjdump = Path(mod.nvcc_path()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        for name, counts in sass_counts(sass).items():
            report.setdefault(f"{prefix}|{name}", {}).update(counts)
    return report


class Runner:
    """Times cases on each checkout's wrappers in the order given."""

    def __init__(self, builds: dict, order: list, reps: int):
        self.builds, self.order, self.reps = builds, order, reps
        self.cases: list = []

    def case(self, name: str, launch, out_shape) -> None:
        dev = torch.device("cuda")
        times = {tag: [] for tag in self.builds}
        first = {}
        for tag in self.order:
            mod = self.builds[tag]
            out = torch.empty(out_shape, device=dev)
            launch(mod, out)
            torch.cuda.synchronize()
            first.setdefault(tag, out.clone())
            ms = []
            for _ in range(self.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch(mod, out)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            times[tag].append(float(np.median(ms)))
        rec = {"case": name, "ms": times,
               "bitwise_the_parent": torch.equal(first["this"],
                                                 first["parent"])}
        log("# case " + json.dumps(rec))
        self.cases.append(rec)


def world(preset: str, name: str, B: int, seed: int):
    """(cfg, params, packed stream, host params, host actions, lanes) of a
    plain stream, a fault intensity or a workload scenario."""
    from ccka_tpu_torch import PRESETS
    from ccka_tpu_torch.config import FAULT_PRESETS
    from ccka_tpu_torch.policy.rule import offpeak_action, peak_action
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.sim.types import SimParams
    from ccka_tpu_torch.workloads.scenarios import (WORKLOAD_SCENARIOS,
                                                    scenario_source)

    dev = torch.device("cuda")
    cfg = PRESETS[preset]()
    if name in WORKLOAD_SCENARIOS:
        sc = WORKLOAD_SCENARIOS[name]
        src = scenario_source(cfg, sc)
        cfg = dataclasses.replace(cfg, workloads=sc.workloads)
    else:
        src = SyntheticSignalSource(
            cfg.cluster, cfg.workload, cfg.sim, cfg.signals,
            faults=None if name == "plain" else FAULT_PRESETS[name])
    params = SimParams.from_config(cfg, device=dev)
    exo = src.packed_trace_device(T_DAY, seed, B, device=dev)
    P, Z = cfg.cluster.n_pools, cfg.cluster.n_zones
    lanes = mk._check_packed(exo, T_DAY, P, Z,
                             int(params.provision_pipeline_k), params)
    acts = torch.stack([mk._pack_action(offpeak_action(cfg.cluster, dev)),
                        mk._pack_action(peak_action(cfg.cluster, dev))])
    return (cfg, params, exo, mk._pack_params(params).cpu().numpy().ravel(),
            acts.cpu().numpy(), dict(fault_base=lanes.fault_base,
                                     wl_base=lanes.wl_base,
                                     wl_depth=lanes.wl_depth))


def random_plan(cfg, B: int, seed: int = 11) -> torch.Tensor:
    from ccka_tpu_torch.models.nets import latent_dim, latent_to_action
    from ccka_tpu_torch.sim import megakernel as mk

    dev = torch.device("cuda")
    lat = 0.3 * torch.randn((B, T_DAY, latent_dim(cfg.cluster)), device=dev,
                            generator=torch.Generator(
                                device=dev).manual_seed(seed))
    return mk.pack_plan(latent_to_action(lat, cfg.cluster), T_DAY)


def launcher(cfg, params, exo, pp, acts, lanes, policy: str, stochastic,
             plan=None, T: int = T_DAY, carry=None):
    """launch(mod, out) of ``policy`` on ``exo`` through mod's wrappers."""
    K = int(params.provision_pipeline_k)
    kw = dict(P=cfg.cluster.n_pools, Z=cfg.cluster.n_zones, K=K, T=T,
              seed=5, stochastic=stochastic, carry=carry, **lanes)
    if policy == "plan":
        return lambda mod, out: mod.launch_rollout_plan(out, exo, pp, plan,
                                                        **kw)
    carbon = CARBON if policy == "carbon" else None
    return lambda mod, out: mod.launch_rollout_profiles(
        out, exo, pp, acts, carbon=carbon, **kw)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="the parent checkout's root (git archive)")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "ab")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    log(f"# card: {smi('name,power.limit')}")

    builds = {}
    for tag, root in (("parent", args.parent.resolve()), ("this", ROOT)):
        t0 = time.perf_counter()
        builds[tag] = load_build(root, tag, args.out / f"_build_{tag}")
        report = build_report(builds[tag])
        (args.out / f"build_{tag}.json").write_text(json.dumps(report,
                                                               indent=0))
        log(f"# {tag}: {root}, built in {time.perf_counter() - t0:.1f} s, "
            f"{len(report)} kernel functions")
    run = Runner(builds, ["parent", "this", "this", "parent"], args.reps)

    # The default rule kernel across fleet sizes, on prefixes of one stream.
    cfg, params, exo_all, pp, acts, lanes = world("default", "plain",
                                                  max(SWEEP), 31)
    busy = launcher(cfg, params, exo_all[:, :, :B_MAIN].contiguous(), pp,
                    acts, lanes, "rule", True)
    out = torch.empty((24, B_MAIN), device=dev)
    for _ in range(40):
        busy(builds["this"], out)
    log(f"# SM clock under load: "
        f"{smi('clocks.sm,clocks.max.sm,power.draw,temperature.gpu')}")
    torch.cuda.synchronize()
    for B in SWEEP:
        exo = exo_all[:, :, :B].contiguous()
        for st in (False, True):
            run.case(f"default rule B={B} {'stochastic' if st else 'det'}",
                     launcher(cfg, params, exo, pp, acts, lanes, "rule", st),
                     (24, B))
    del exo_all, exo

    # The multiregion kernels on a plain stream.
    cfg, params, exo, pp, acts, lanes = world("multiregion", "plain",
                                              B_MAIN, 53)
    plan = random_plan(cfg, B_MAIN)
    for st in (True, False):
        for policy in ("rule", "carbon", "plan"):
            run.case(f"multiregion {policy} B={B_MAIN} "
                     f"{'stochastic' if st else 'det'}",
                     launcher(cfg, params, exo, pp, acts, lanes, policy, st,
                              plan), (24, B_MAIN))

    # The lane instantiations, and a CARRY day on the mixed stream.
    for name in ("severe", "mixed"):
        cfg, params, exo, pp, acts, lanes = world("multiregion", name,
                                                  B_MAIN, 97)
        plan = random_plan(cfg, B_MAIN)
        for policy in ("rule", "carbon", "plan"):
            run.case(f"{name} {policy} B={B_MAIN} stochastic",
                     launcher(cfg, params, exo, pp, acts, lanes, policy,
                              True, plan), (24, B_MAIN))
        if name != "mixed":
            continue
        blocks = [(exo[t:t + BLOCK].contiguous(),
                   plan[t:t + BLOCK].contiguous())
                  for t in range(0, T_DAY, BLOCK)]
        for policy in ("rule", "carbon", "plan"):
            def day(mod, out, policy=policy):
                s_in = torch.zeros((STATE_ROWS, B_MAIN), device=dev)
                s_out = torch.empty_like(s_in)
                for j, (blk, pblk) in enumerate(blocks):
                    launcher(cfg, params, blk, pp, acts, lanes, policy, True,
                             pblk, BLOCK,
                             mod.BlockCarry(s_in, s_out, j * BLOCK))(mod,
                                                                      None)
                    s_in, s_out = s_out, s_in
                out.copy_(s_in[:24])

            run.case(f"mixed {policy} CARRY day {T_DAY // BLOCK}x{BLOCK} "
                     f"B={B_MAIN} stochastic", day, (24, B_MAIN))

    # The MLP kernel, whose tick is the same header.
    from ccka_tpu_torch.models.nets import (AFTER_MAX_S, HPA_BIAS, HPA_HI,
                                            HPA_LO)
    from ccka_tpu_torch.policy.constraints import slo_pool_mask
    from ccka_tpu_torch.sim import megakernel as mk
    from ccka_tpu_torch.train.flagship import load_flagship_backend

    cfg, params, exo, pp, _, lanes = world("multiregion", "plain", B_MAIN,
                                           53)
    weights = mk._pack_mlp_tensors(
        load_flagship_backend(cfg, device=dev)[0].params, dev)
    slo = slo_pool_mask(cfg.cluster, "cpu").numpy()
    codec = np.array([AFTER_MAX_S, HPA_LO, HPA_HI - HPA_LO, HPA_BIAS],
                     np.float32)
    run.case(f"multiregion MLP B={B_MAIN} stochastic",
             lambda mod, out: mod.launch_rollout_mlp(
                 out, exo, pp, slo, codec, weights, P=cfg.cluster.n_pools,
                 Z=cfg.cluster.n_zones,
                 K=int(params.provision_pipeline_k), T=T_DAY, seed=5,
                 stochastic=True, **lanes), (1, 24, B_MAIN))

    (args.out / "cases.json").write_text(json.dumps(run.cases, indent=1))
    print(smi("name,power.limit"))
    if not all(c["bitwise_the_parent"] for c in run.cases):
        sys.exit("this checkout's output differs from the parent's")


if __name__ == "__main__":
    main()
