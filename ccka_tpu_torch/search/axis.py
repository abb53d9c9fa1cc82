"""Scenario-axis signal source: S parameterizations x B clusters in one
packed stream.

The PyTorch form of `ccka_tpu/search/axis.py`. :class:`ScenarioAxisSource`
subclasses the synthetic source and folds an ``[S]`` axis of scenario
parameters (`search/params.py::ScenarioParams`) into the packed stream's
batch axis, cell-major: column ``s * inner + b`` is cell s, cluster b, so
one kernel launch on the stream scores every cell and a summary reshapes
per field to ``[S, inner]`` (:func:`summary_cells`).

What does not depend on the parameters is made once at the inner width:
the exo noise and block (from the same generator, shapes and draw order
as the baked source, so every cell's exo rows are bitwise the un-searched
stream's), and each lane family's draws (its own generator,
`signals/synthetic.py::family_generator`). Only the arithmetic that
depends on the parameters carries S: each family's traced-parameter
generator (`sim/lanes.py::lane_param_generator`) turns the shared draws
into S cells' lanes, so every candidate sees the same storms (common
random numbers). The whole stream is written into one
``[T_pad, rows, S * inner]`` tensor, block by block.

Batch contract: the ``batch`` of every generation entry is the total
column count and must be divisible by S, which is what lets the streaming
pipeline (`sim/streaming.py`) drive the source like any other.

``S = 1`` is bitwise the config-baked `SyntheticSignalSource` of the same
cell on the same seed, packed and blocked (`tests/test_torch_search.py`;
`chip_smoke.py` phase 17 on the card), and so is each cell of an S-cell
stream: the per-cell operations are the baked ones, elementwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ccka_tpu_torch import resolve_device
from ccka_tpu_torch.config import (ClusterConfig, FaultsConfig, GeoConfig,
                                   SignalsConfig, SimConfig, WorkloadConfig,
                                   WorkloadsConfig)
from ccka_tpu_torch.search.params import ScenarioParams
from ccka_tpu_torch.signals.synthetic import (_AR1_CARBON, _AR1_DEMAND,
                                              _AR1_SPOT,
                                              SyntheticSignalSource,
                                              _ar1_scan, family_generator)
from ccka_tpu_torch.sim import lanes


class ScenarioAxisSource(SyntheticSignalSource):
    """Synthetic packed-stream source with an ``[S]`` axis of scenario
    parameters folded into the batch axis (module docstring). ``geo``
    (enabled) adds the region block; ``faults`` and ``workloads`` give
    the fault and workload blocks their presence (every searchable field
    comes from the parameters)."""

    def __init__(self, cluster: ClusterConfig, workload: WorkloadConfig,
                 sim: SimConfig, signals: SignalsConfig,
                 params: ScenarioParams, *,
                 faults: FaultsConfig | None = None,
                 workloads: WorkloadsConfig | None = None,
                 geo: GeoConfig | None = None,
                 start_unix_s: float = 0.0):
        extra = ({"regions": geo}
                 if geo is not None and geo.enabled else None)
        super().__init__(cluster, workload, sim, signals,
                         start_unix_s=start_unix_s, faults=faults,
                         workloads=workloads, extra_lanes=extra)
        self.set_params(params)

    @property
    def params(self) -> ScenarioParams:
        return self._params

    def set_params(self, params: ScenarioParams) -> None:
        """Swap the batch of parameters; the next stream is made from it.
        The ``*_generate_fn`` closures made before keep the batch they
        were made with."""
        if not isinstance(params, ScenarioParams):
            raise TypeError("ScenarioAxisSource needs a ScenarioParams "
                            f"batch; got {type(params).__name__}")
        self._params = params
        self._derived = params.derived()

    def packed_generate_fn(self, steps: int, batch: int, *,
                           t_pad: int | None = None, device=None):
        """``seed -> [T_pad, packed_rows(), batch]`` with the current
        parameters bound (``batch`` the total columns, S x inner)."""
        dev = resolve_device(device)
        t_pad = steps if t_pad is None else int(t_pad)
        if t_pad < steps:
            raise ValueError(f"t_pad={t_pad} < steps={steps}")
        derived = self._derived

        def generate(seed: int) -> torch.Tensor:
            return self._cells(derived, int(seed), steps, t_pad, batch, dev)

        return generate

    def packed_block_generate_fn(self, block_T: int, batch: int, *,
                                 t_chunk: int = 64, device=None):
        """The streaming pipeline's unit of synthesis
        (`SyntheticSignalSource.packed_block_generate_fn`), ``(block_seed,
        t0_ticks, out=None) -> [block_T, packed_rows(), batch]``, with the
        current parameters bound."""
        lanes.block_layout(block_T, block_T, t_chunk)  # divisibility
        dev = resolve_device(device)
        derived = self._derived

        def generate(seed: int, t0_ticks: int,
                     out: torch.Tensor | None = None) -> torch.Tensor:
            return self._cells(derived, int(seed), block_T, block_T, batch,
                               dev, t0_ticks=int(t0_ticks), out=out)

        return generate

    def _synthesize(self, seed: int, steps: int, t_pad: int, batch: int,
                    dev, *, t0_ticks: int | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
        """The base class's synthesis entry, from the current
        parameters."""
        return self._cells(self._derived, seed, steps, t_pad, batch, dev,
                           t0_ticks=t0_ticks, out=out)

    def _cells(self, derived: dict, seed: int, steps: int, t_pad: int,
               batch: int, dev, *, t0_ticks: int | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
        """One packed stream of S cells x ``batch // S`` clusters from
        ``seed`` and ``derived`` (`ScenarioParams.derived()`), written into
        ``out`` (or a new tensor) block by block: the base class's exo
        block at the inner width for every cell, each lane block from its
        family's traced-parameter generator."""
        S = len(derived["faults"]["storm_thresh"])
        if batch % S:
            raise ValueError(
                f"batch is the total column count and must be divisible "
                f"by the scenario count: batch={batch}, S={S}")
        inner = batch // S
        z = self.cluster.n_zones
        rows = self.packed_rows()
        out = self._stream_out(out, (t_pad, rows, batch), dev)
        plan = []
        for fam, cfg in self._lane_configs():
            gen_p = lanes.lane_param_generator(fam.name)
            if gen_p is None:
                raise ValueError(f"lane family {fam.name!r} has no "
                                 "traced-parameter generator")
            plan.append((fam, cfg, gen_p))
        cells = out.view(t_pad, rows, S, inner)
        g = family_generator(seed, None, dev)
        noise = (_ar1_scan(g, (steps, z, inner), *_AR1_SPOT),
                 _ar1_scan(g, (steps, z, inner), *_AR1_CARBON),
                 _ar1_scan(g, (steps, inner), *_AR1_DEMAND))
        base = lanes.exo_rows(z)
        cells[:, :base] = self._assemble_packed(
            steps, t_pad, noise, t0_ticks=t0_ticks)[:, :, None, :]
        offset = None
        if t0_ticks is not None:
            offset = np.full(inner, np.float32(t0_ticks)
                             * np.float32(self.sim.dt_s), np.float32)
        ctx = dict(price_dev=noise[0], dt_s=self.sim.dt_s,
                   start_unix_s=self.start_unix_s, start_offset_s=offset)
        for fam, cfg, gen_p in plan:
            hi = base + fam.rows(z)
            gen_p(cfg, derived[fam.name],
                  family_generator(seed, fam.key_tag, dev), steps, t_pad, z,
                  inner, ctx=ctx, out=cells[:, base:hi])
            base = hi
        return out


def summary_cells(summary, S: int, fields=None) -> dict:
    """Per-cell objectives off a summary scored on an S-cell stream: each
    per-cluster field reshaped ``[S, inner]`` and meaned over the inner
    clusters in float64 -> {field: float64 [S]}. ``fields`` defaults to
    the workload scoreboard's row fields
    (`workloads/scoreboard.py::_ROW_FIELDS`), so searched and hand-named
    cells speak one vocabulary."""
    if fields is None:
        from ccka_tpu_torch.workloads.scoreboard import _ROW_FIELDS

        fields = _ROW_FIELDS
    out = {}
    for f in fields:
        x = getattr(summary, f).detach().to("cpu", torch.float64).numpy()
        x = x.reshape(-1)
        if x.size % S:
            raise ValueError(f"summary field {f!r} has {x.size} elements"
                             f" — not divisible by S={S}")
        out[f] = x.reshape(S, x.size // S).mean(axis=1)
    return out
