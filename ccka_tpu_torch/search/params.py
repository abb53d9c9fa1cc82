"""Batched scenario parameters: the ``[S]`` axis over the searchable
knobs of the fault, workload and geo sections.

The PyTorch port's copy of `ccka_tpu/search/params.py` (numpy and the
standard library only, so its digests are the JAX package's and a
scenario minted by one package loads in the other). :class:`ScenarioParams`
holds S parameterizations as float64 natural-unit host arrays (exact
`from_config` / `to_config` round trips), and :meth:`ScenarioParams.
derived` lowers them to the float32 values the lane generators of the
scenario axis consume (window thresholds, AR(1) persistence and noise
scale, rates and multipliers).

The bitwise contract: the derived values are computed on the host with
the arithmetic of the config-baked generators (``NormalDist().inv_cdf``
in float64 for thresholds, ``math.exp(-1/max(mean_ticks, 1))`` for rho,
``float32(sqrt(1 - rho^2))`` for the AR(1) noise scale), so an ``S = 1``
axis stream is bitwise the baked stream of the same config. The port's
doubling scan (`signals/synthetic.py::_ar1_scan`) forms its coefficients
``rho, rho^2, rho^4, ...`` and ``rho^t`` in float64 before rounding them,
so each window also carries its float64 rho (``*_rho64``), an addition to
the JAX package's dict.

`SEARCH_BOUNDS` is the validated box the adversarial search
(`search/adversarial.py`) explores: every point of it satisfies the
config validators, so any clipped point mints a valid scenario, and
:meth:`ScenarioParams.clip_to_bounds` is idempotent.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from statistics import NormalDist
from typing import NamedTuple

import numpy as np

from ccka_tpu_torch.config import FaultsConfig, GeoConfig, WorkloadsConfig


class ParamSpec(NamedTuple):
    """One searchable knob: its short search name, the lane family whose
    traced core consumes it (``faults``/``workloads``/``regions``), the
    config section + field it round-trips through, its kind (``int``
    fields round onto the tick lattice), and the search box."""

    name: str
    family: str     # lane-family name (the derived() dict key)
    section: str    # config section: "faults" | "workloads" | "geo"
    field: str      # config dataclass field
    kind: str       # "float" | "int"
    lo: float
    hi: float


# The searchable box. Bounds are chosen to satisfy the config
# validators at every point (see module docstring) and to span well
# past the hand-named presets (FAULT_PRESETS "severe" storms at
# hazard 4 / frac 0.2; WORKLOAD_SCENARIOS flash mults up to 8).
SEARCH_SPEC: tuple[ParamSpec, ...] = (
    # -- faults: the full continuous FaultsConfig surface.
    ParamSpec("storm_hazard", "faults", "faults",
              "preempt_storm_hazard", "float", 0.0, 6.0),
    ParamSpec("storm_frac", "faults", "faults",
              "preempt_storm_frac", "float", 0.0, 0.5),
    ParamSpec("storm_mean_ticks", "faults", "faults",
              "preempt_storm_mean_ticks", "int", 1, 64),
    ParamSpec("price_coupling", "faults", "faults",
              "preempt_price_coupling", "float", 0.0, 3.0),
    ParamSpec("ice_frac", "faults", "faults", "ice_frac", "float",
              0.0, 0.5),
    ParamSpec("ice_deny_frac", "faults", "faults", "ice_deny_frac",
              "float", 0.0, 1.0),
    ParamSpec("ice_mean_ticks", "faults", "faults", "ice_mean_ticks",
              "int", 1, 64),
    ParamSpec("delay_frac", "faults", "faults", "delay_jitter_frac",
              "float", 0.0, 0.9),
    ParamSpec("outage_frac", "faults", "faults", "outage_frac",
              "float", 0.0, 0.5),
    ParamSpec("outage_mean_ticks", "faults", "faults",
              "outage_mean_ticks", "int", 1, 64),
    # -- workloads: rates + spike amplitudes (queue/SLO/deadline knobs
    # are kernel-side SimParams, not generation-side — not searchable
    # here).
    ParamSpec("inf_rate", "workloads", "workloads",
              "inference_rate_pods", "float", 0.0, 24.0),
    ParamSpec("inf_flash_frac", "workloads", "workloads",
              "inference_flash_frac", "float", 0.0, 0.5),
    ParamSpec("inf_flash_mult", "workloads", "workloads",
              "inference_flash_mult", "float", 1.0, 16.0),
    ParamSpec("inf_flash_mean_ticks", "workloads", "workloads",
              "inference_flash_mean_ticks", "int", 1, 64),
    ParamSpec("batch_rate", "workloads", "workloads",
              "batch_rate_pods", "float", 0.0, 24.0),
    ParamSpec("batch_burst_frac", "workloads", "workloads",
              "batch_burst_frac", "float", 0.0, 0.5),
    ParamSpec("batch_burst_mult", "workloads", "workloads",
              "batch_burst_mult", "float", 1.0, 16.0),
    ParamSpec("batch_burst_mean_ticks", "workloads", "workloads",
              "batch_burst_mean_ticks", "int", 1, 64),
    ParamSpec("bg_rate", "workloads", "workloads",
              "background_rate_pods", "float", 0.0, 12.0),
    # -- geo: the regional spot-storm block (sigma/capacity/migration
    # knobs stay config-static — the storm is what the DCcluster-Opt
    # suite stresses).
    ParamSpec("geo_storm_frac", "regions", "geo", "price_storm_frac",
              "float", 0.0, 0.5),
    ParamSpec("geo_storm_mult", "regions", "geo", "price_storm_mult",
              "float", 1.0, 8.0),
    ParamSpec("geo_storm_mean_ticks", "regions", "geo",
              "price_storm_mean_ticks", "int", 1, 64),
    ParamSpec("geo_storm_carbon", "regions", "geo",
              "price_storm_carbon_g_kwh", "float", 0.0, 400.0),
)

PARAM_NAMES: tuple[str, ...] = tuple(p.name for p in SEARCH_SPEC)
_SPEC_BY_NAME: dict[str, ParamSpec] = {p.name: p for p in SEARCH_SPEC}

# {param name: (lo, hi)} — the validated search box (CLI bounds flags
# override entries; unknown names are rejected up front).
SEARCH_BOUNDS: dict[str, tuple[float, float]] = {
    p.name: (p.lo, p.hi) for p in SEARCH_SPEC}


def validate_bounds(bounds: dict[str, tuple[float, float]]) -> None:
    """Reject unknown knob names and inverted/out-of-box ranges up
    front (a typo must not run a long search against the wrong box)."""
    bad = [n for n in bounds if n not in _SPEC_BY_NAME]
    if bad:
        raise ValueError(f"unknown scenario params {sorted(bad)}; "
                         f"searchable: {list(PARAM_NAMES)}")
    for name, (lo, hi) in bounds.items():
        sp = _SPEC_BY_NAME[name]
        if not (sp.lo <= lo <= hi <= sp.hi):
            raise ValueError(
                f"bounds for {name!r} must satisfy "
                f"{sp.lo} <= lo <= hi <= {sp.hi}; got ({lo}, {hi})")


def _threshold64(frac: float) -> float:
    """The baked generators' host-side Gaussian window threshold
    (`faults/process._threshold`), in f64: ``frac<=0`` -> +inf
    (a zero-rate window is exactly never active)."""
    if frac <= 0.0:
        return float("inf")
    return float(NormalDist().inv_cdf(1.0 - frac))


def _window_rho64(mean_ticks: np.ndarray) -> np.ndarray:
    """Float64 AR(1) persistence of each window length, as the baked
    generators compute it: ``exp(-1/max(round(mean_ticks), 1))``."""
    return np.asarray([math.exp(-1.0 / max(int(round(float(m))), 1))
                       for m in mean_ticks], np.float64)


def _window_derived(frac: np.ndarray, mean_ticks: np.ndarray):
    """Per-window derived coefficients: (thresh, rho, scale) float32 [S]
    arrays, computed with exactly the baked path's arithmetic: ``rho =
    exp(-1/max(round(mean_ticks), 1))`` in float64 then cast, and
    ``scale = f32(sqrt(1 - rho64^2))``, the baked scan's noise scale
    (re-deriving it from the float32 rho would differ by an ulp)."""
    thresh = np.asarray([_threshold64(float(f)) for f in frac],
                        np.float32)
    rho64 = _window_rho64(mean_ticks)
    rho = rho64.astype(np.float32)
    scale = np.asarray([np.float32(np.sqrt(1.0 - r * r)) for r in rho64],
                       np.float32)
    return thresh, rho, scale


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """``S`` scenario parameterizations: {knob name: float64 [S] array}
    in natural config units (see module docstring)."""

    values: dict  # name -> np.ndarray float64 [S]

    def __post_init__(self):
        if set(self.values) != set(PARAM_NAMES):
            missing = set(PARAM_NAMES) - set(self.values)
            extra = set(self.values) - set(PARAM_NAMES)
            raise ValueError(f"ScenarioParams needs exactly the "
                             f"searchable knobs; missing={sorted(missing)} "
                             f"extra={sorted(extra)}")
        sizes = {np.asarray(v).shape for v in self.values.values()}
        if len(sizes) != 1 or len(next(iter(sizes))) != 1:
            raise ValueError(f"ScenarioParams values must all be 1-D "
                             f"same-length arrays; got shapes {sizes}")

    @property
    def S(self) -> int:
        return int(next(iter(self.values.values())).shape[0])

    # -- config round trip (exact; tests/test_torch_search.py) ---------

    @classmethod
    def from_config(cls, faults: FaultsConfig | None = None,
                    workloads: WorkloadsConfig | None = None,
                    geo: GeoConfig | None = None) -> "ScenarioParams":
        """S=1 params reading the searchable fields of the given config
        sections (None: that section's dataclass defaults)."""
        sections = {"faults": faults if faults is not None
                    else FaultsConfig(),
                    "workloads": workloads if workloads is not None
                    else WorkloadsConfig(),
                    "geo": geo if geo is not None else GeoConfig()}
        vals = {p.name: np.asarray(
            [float(getattr(sections[p.section], p.field))], np.float64)
            for p in SEARCH_SPEC}
        return cls(vals)

    def to_config(self, i: int = 0, *,
                  base_faults: FaultsConfig | None = None,
                  base_workloads: WorkloadsConfig | None = None,
                  base_geo: GeoConfig | None = None):
        """``(FaultsConfig, WorkloadsConfig, GeoConfig)`` of cell ``i``:
        the searchable fields from this batch (ints rounded onto the
        tick lattice), everything else from the base sections (defaults:
        enabled instances — a minted scenario's configs must actually
        synthesize lanes)."""
        bases = {"faults": base_faults if base_faults is not None
                 else FaultsConfig(enabled=True),
                 "workloads": base_workloads if base_workloads is not None
                 else WorkloadsConfig(enabled=True),
                 "geo": base_geo if base_geo is not None
                 else GeoConfig(enabled=True)}
        updates: dict[str, dict] = {"faults": {}, "workloads": {},
                                    "geo": {}}
        for p in SEARCH_SPEC:
            v = float(np.asarray(self.values[p.name])[i])
            updates[p.section][p.field] = (int(round(v)) if p.kind == "int"
                                           else v)
        return tuple(dataclasses.replace(bases[s], **updates[s])
                     for s in ("faults", "workloads", "geo"))

    # -- array/batch plumbing (the CEM loop's view) -------------------

    @classmethod
    def from_array(cls, x: np.ndarray) -> "ScenarioParams":
        """``[S, D]`` natural-unit matrix (columns in `PARAM_NAMES`
        order) -> params batch."""
        x = np.asarray(x, np.float64)
        if x.ndim != 2 or x.shape[1] != len(PARAM_NAMES):
            raise ValueError(f"expected [S, {len(PARAM_NAMES)}] matrix; "
                             f"got {x.shape}")
        return cls({n: np.ascontiguousarray(x[:, j])
                    for j, n in enumerate(PARAM_NAMES)})

    def to_array(self) -> np.ndarray:
        """``[S, D]`` natural-unit matrix, columns in `PARAM_NAMES`
        order."""
        return np.stack([np.asarray(self.values[n], np.float64)
                         for n in PARAM_NAMES], axis=1)

    @classmethod
    def stack(cls, cells) -> "ScenarioParams":
        """Concatenate params batches along S."""
        cells = list(cells)
        if not cells:
            raise ValueError("no cells to stack")
        return cls({n: np.concatenate(
            [np.asarray(c.values[n], np.float64) for c in cells])
            for n in PARAM_NAMES})

    def row(self, i: int) -> "ScenarioParams":
        """The S=1 batch holding only cell ``i``."""
        return ScenarioParams({n: np.asarray(self.values[n],
                                             np.float64)[i:i + 1].copy()
                               for n in PARAM_NAMES})

    def clip_to_bounds(self, bounds: dict | None = None
                       ) -> "ScenarioParams":
        """Project into the (validated) search box; integer knobs round
        onto the lattice first so the projection is IDEMPOTENT."""
        box = dict(SEARCH_BOUNDS)
        if bounds:
            validate_bounds(bounds)
            box.update(bounds)
        out = {}
        for p in SEARCH_SPEC:
            v = np.asarray(self.values[p.name], np.float64)
            if p.kind == "int":
                v = np.round(v)
            lo, hi = box[p.name]
            out[p.name] = np.clip(v, lo, hi)
        return ScenarioParams(out)

    # -- the traced cores' view ---------------------------------------

    def derived(self) -> dict:
        """{lane-family name: {derived name: float32 [S] array}}: the
        values the families' traced-parameter generators consume
        (`sim/lanes.py::lane_param_generator`), the JAX package's dict,
        plus a float64 ``<window>_rho64`` beside each window's rho (the
        port's scan coefficients, see the module docstring). Pure host
        computation."""
        g = lambda n: np.asarray(self.values[n], np.float64)  # noqa: E731
        f32 = lambda n: g(n).astype(np.float32)               # noqa: E731

        def window(prefix: str, frac: str, ticks: str) -> dict:
            t, r, sc = _window_derived(g(frac), g(ticks))
            return {f"{prefix}_thresh": t, f"{prefix}_rho": r,
                    f"{prefix}_scale": sc,
                    f"{prefix}_rho64": _window_rho64(g(ticks))}

        return {
            "faults": {
                **window("storm", "storm_frac", "storm_mean_ticks"),
                "storm_hazard": f32("storm_hazard"),
                "price_coupling": f32("price_coupling"),
                **window("ice", "ice_frac", "ice_mean_ticks"),
                "ice_deny": f32("ice_deny_frac"),
                "delay_frac": f32("delay_frac"),
                **window("outage", "outage_frac", "outage_mean_ticks"),
            },
            "workloads": {
                "inf_rate": f32("inf_rate"),
                **window("flash", "inf_flash_frac", "inf_flash_mean_ticks"),
                "flash_mult": f32("inf_flash_mult"),
                "batch_rate": f32("batch_rate"),
                **window("burst", "batch_burst_frac",
                         "batch_burst_mean_ticks"),
                "burst_mult": f32("batch_burst_mult"),
                "bg_rate": f32("bg_rate"),
            },
            "regions": {
                **window("storm", "geo_storm_frac", "geo_storm_mean_ticks"),
                "storm_mult": f32("geo_storm_mult"),
                "storm_carbon": f32("geo_storm_carbon"),
            },
        }

    # -- provenance (the minted-scenario tamper contract) -------------

    def to_json(self) -> str:
        """Canonical full-precision JSON (sorted keys, repr floats —
        exact f64 round trip) — the digest preimage."""
        return json.dumps(
            {n: [float(v) for v in np.asarray(self.values[n], np.float64)]
             for n in PARAM_NAMES},
            sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, s: str) -> "ScenarioParams":
        doc = json.loads(s)
        return cls({n: np.asarray(doc[n], np.float64)
                    for n in PARAM_NAMES})

    def digest(self, i: int | None = None) -> str:
        """sha256 of the canonical JSON (of cell ``i`` when given) —
        the provenance digest a minted `Scenario` stores and
        `Scenario.validate` re-checks (tamper refusal)."""
        p = self if i is None else self.row(i)
        return hashlib.sha256(p.to_json().encode()).hexdigest()


def params_digest(params_json: str) -> str:
    """sha256 of a stored canonical params JSON string — the one
    digest function `Scenario.validate` and the minting path share
    (numpy and the standard library only)."""
    return hashlib.sha256(params_json.encode()).hexdigest()
