"""The named scenario library: workload-family mixes x fault presets.

The PyTorch form of `ccka_tpu/workloads/scenarios.py` for the hand-named
library. A :class:`Scenario` is a named, validated (workload-family mix,
fault preset) pair: the vocabulary of the per-family scoreboard
(`workloads/scoreboard.py`). Rates are sized against the demo topology
(60-pod burst peak, 9 pods a node, 3 base nodes), so inference queues
build under tight fleets and batch work needs sustained slack.

Scenarios minted by the adversarial search (explicit ``faults``/``geo``
sections with a ``params_json``/``params_digest`` provenance pair) need
the search parameters and the region lanes, which the port has not yet
(ROADMAP queue A item 13): such a scenario raises NotImplementedError
here rather than run without its digest check.
"""

from __future__ import annotations

from dataclasses import dataclass

from ccka_tpu_torch.config import (FAULT_PRESETS, FaultsConfig, GeoConfig,
                                   WorkloadsConfig, _asdict)

_MINTED = ("minted scenarios (params_json/params_digest, geo sections) "
           "need the search parameters and region lanes the port has not "
           "yet: ROADMAP queue A item 13")


@dataclass(frozen=True)
class Scenario:
    """One named benchmark scenario. ``fault_preset`` names a
    `FAULT_PRESETS` entry composed into the same stream ("" = calm, no
    fault lanes); scenarios and intensities share one seed, so every
    scenario's exo rows are bitwise those of its calm twin."""

    name: str
    description: str
    workloads: WorkloadsConfig
    fault_preset: str = ""
    faults: FaultsConfig | None = None
    geo: GeoConfig | None = None
    params_json: str = ""
    params_digest: str = ""
    minted_by: str = ""

    def validate(self) -> None:
        self.workloads.validate()
        if not self.workloads.enabled:
            raise ValueError(f"scenario {self.name!r}: workloads disabled")
        if self.fault_preset and self.fault_preset not in FAULT_PRESETS:
            raise ValueError(
                f"scenario {self.name!r}: unknown fault preset "
                f"{self.fault_preset!r}; presets: {sorted(FAULT_PRESETS)}")
        if self.faults is not None:
            self.faults.validate()
        if self.params_json or self.params_digest or (
                self.geo is not None and self.geo.enabled):
            raise NotImplementedError(f"scenario {self.name!r}: {_MINTED}")

    @property
    def minted(self) -> bool:
        """Whether this scenario carries search-mint provenance."""
        return bool(self.params_digest)

    def family_mix(self) -> dict[str, float]:
        """Mean arrival rate per family."""
        w = self.workloads
        return {"inference": w.inference_rate_pods,
                "batch": w.batch_rate_pods,
                "background": w.background_rate_pods}

    def to_doc(self) -> dict:
        """JSON-serializable document, the JAX package's layout."""
        doc = {"name": self.name, "description": self.description,
               "workloads": _asdict(self.workloads),
               "fault_preset": self.fault_preset,
               "params_json": self.params_json,
               "params_digest": self.params_digest,
               "minted_by": self.minted_by}
        if self.faults is not None:
            doc["faults"] = _asdict(self.faults)
        if self.geo is not None:
            doc["geo"] = _asdict(self.geo)
        return doc


WORKLOAD_SCENARIOS: dict[str, Scenario] = {
    "diurnal-inference": Scenario(
        name="diurnal-inference",
        description="latency-sensitive inference serving: diurnal "
                    "request load with occasional mild flash crowds",
        workloads=WorkloadsConfig(
            enabled=True, inference_rate_pods=6.0,
            inference_flash_frac=0.02, inference_flash_mult=3.0)),
    "flash-crowd": Scenario(
        name="flash-crowd",
        description="inference serving under heavy flash crowds: the "
                    "same diurnal base, 8x spikes in frequent windows",
        workloads=WorkloadsConfig(
            enabled=True, inference_rate_pods=6.0,
            inference_flash_frac=0.06, inference_flash_mult=8.0,
            inference_flash_mean_ticks=8)),
    "batch-backfill": Scenario(
        name="batch-backfill",
        description="deadline-driven batch backfill waves (anti-diurnal) "
                    "plus a best-effort background floor",
        workloads=WorkloadsConfig(
            enabled=True, batch_rate_pods=5.0, batch_burst_frac=0.08,
            batch_burst_mult=6.0, background_rate_pods=3.0)),
    "mixed": Scenario(
        name="mixed",
        description="all three families sharing one fleet, under mild "
                    "fault weather (the millions-of-users composite)",
        workloads=WorkloadsConfig(
            enabled=True, inference_rate_pods=6.0,
            inference_flash_frac=0.04, inference_flash_mult=6.0,
            batch_rate_pods=5.0, batch_burst_frac=0.06,
            background_rate_pods=3.0),
        fault_preset="mild"),
}


def resolve_scenarios(names) -> dict[str, Scenario]:
    """Validated name -> Scenario map; unknown names are rejected up
    front, before any stream is made."""
    names = [n for n in names if n]
    if not names:
        raise ValueError(f"no scenarios named; library: "
                         f"{sorted(WORKLOAD_SCENARIOS)}")
    bad = [n for n in names if n not in WORKLOAD_SCENARIOS]
    if bad:
        raise ValueError(f"unknown scenarios {bad}; library: "
                         f"{sorted(WORKLOAD_SCENARIOS)}")
    out = {n: WORKLOAD_SCENARIOS[n] for n in names}
    for sc in out.values():
        sc.validate()
    return out


def scenario_source(cfg, scenario: Scenario):
    """A SyntheticSignalSource for this scenario's widened stream:
    workload lanes, plus fault lanes when the scenario names a preset or
    carries a faults section. Scenarios drawn from one seed share their
    exo rows bitwise."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    scenario.validate()
    faults = scenario.faults
    if faults is None and scenario.fault_preset:
        faults = FAULT_PRESETS[scenario.fault_preset]
    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals, faults=faults,
                                 workloads=scenario.workloads)
