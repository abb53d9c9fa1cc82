"""The named scenario library: workload-family mixes x fault presets.

The PyTorch form of `ccka_tpu/workloads/scenarios.py` for the hand-named
library. A :class:`Scenario` is a named, validated (workload-family mix,
fault preset) pair: the vocabulary of the per-family scoreboard
(`workloads/scoreboard.py`). Rates are sized against the demo topology
(60-pod burst peak, 9 pods a node, 3 base nodes), so inference queues
build under tight fleets and batch work needs sustained slack.

A scenario can also be minted by the adversarial search
(`search/adversarial.py`): explicit ``faults``/``geo`` sections in place
of a preset name, and the provenance pair ``params_json`` (the canonical
`search/params.py::ScenarioParams` JSON of the cell) and
``params_digest`` (its sha256). :meth:`Scenario.validate` refuses a
minted scenario whose digest does not match its parameters, and the
codec (:func:`scenario_from_doc`, :func:`load_minted_scenarios`) is the
JAX package's document layout, so a scenario minted by either package
loads in the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ccka_tpu_torch.config import (FAULT_PRESETS, FaultsConfig, GeoConfig,
                                   WorkloadsConfig, _asdict, _from_dict)


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
        if self.geo is not None:
            self.geo.validate()
        if bool(self.params_json) != bool(self.params_digest):
            raise ValueError(
                f"scenario {self.name!r}: minted provenance needs BOTH "
                "params_json and params_digest (one without the other "
                "is an unverifiable record)")
        if self.params_json:
            from ccka_tpu_torch.search.params import params_digest

            got = params_digest(self.params_json)
            if got != self.params_digest:
                raise ValueError(
                    f"scenario {self.name!r}: params digest mismatch — "
                    f"stored {self.params_digest[:12]}…, params hash to "
                    f"{got[:12]}…. The stored parameters were modified "
                    "after minting; refusing a tampered scenario.")

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
        """JSON-serializable document, the JAX package's layout, which
        :func:`scenario_from_doc` inverts."""
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


def scenario_from_doc(doc: dict) -> Scenario:
    """A scenario rebuilt from its document and validated, the digest
    check included."""
    sc = Scenario(
        name=str(doc["name"]), description=str(doc.get("description", "")),
        workloads=_from_dict(WorkloadsConfig, doc["workloads"]),
        fault_preset=str(doc.get("fault_preset", "")),
        faults=(_from_dict(FaultsConfig, doc["faults"])
                if doc.get("faults") is not None else None),
        geo=(_from_dict(GeoConfig, doc["geo"])
             if doc.get("geo") is not None else None),
        params_json=str(doc.get("params_json", "")),
        params_digest=str(doc.get("params_digest", "")),
        minted_by=str(doc.get("minted_by", "")))
    sc.validate()
    return sc


def load_minted_scenarios(path: str) -> dict[str, Scenario]:
    """Minted scenarios from a ``--mint-out`` JSON file or a directory of
    them, each validated (digest-checked) on load. A name that is already
    taken, by the hand-named library or an earlier file, is refused: a
    minted cell must not shadow a published row."""
    files = []
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(".json")]
    elif os.path.exists(path):
        files = [path]
    out: dict[str, Scenario] = {}
    for f in files:
        with open(f, encoding="utf-8") as fh:
            doc = json.load(fh)
        sc = scenario_from_doc(doc.get("scenario", doc))
        if sc.name in WORKLOAD_SCENARIOS or sc.name in out:
            raise ValueError(f"minted scenario {sc.name!r} ({f}) "
                             "collides with an existing scenario name")
        out[sc.name] = sc
    return out


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
    carries a faults section, plus region lanes for an enabled geo
    section (a minted one). Scenarios drawn from one seed share their
    exo rows bitwise."""
    from ccka_tpu_torch.signals.synthetic import SyntheticSignalSource

    scenario.validate()
    faults = scenario.faults
    if faults is None and scenario.fault_preset:
        faults = FAULT_PRESETS[scenario.fault_preset]
    extra = ({"regions": scenario.geo}
             if scenario.geo is not None and scenario.geo.enabled else None)
    return SyntheticSignalSource(cfg.cluster, cfg.workload, cfg.sim,
                                 cfg.signals, faults=faults,
                                 workloads=scenario.workloads,
                                 extra_lanes=extra)
