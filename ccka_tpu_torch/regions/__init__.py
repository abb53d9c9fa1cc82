"""Geo arbitrage: per-region lane processes, inter-region migration and
the cost / carbon / SLO Pareto scoreboard.

The PyTorch form of `ccka_tpu/regions/`. `process` synthesizes the
per-region price, carbon, capacity and migratable-arrival lanes as the
"regions" block of the packed stream (`sim/lanes.py`); `migrate` defines
the migration action space, its conservation sanitizer and its command
wire; `geo` runs the batched expectation dynamics that move pending mass
between regions; `pareto` scores the policies as fronts per workload
class.
"""

from ccka_tpu_torch.regions.process import (  # noqa: F401
    REGION_KEY_TAG,
    REGION_LANE_FIELDS,
    RegionStep,
    has_region_lanes,
    packed_region_lanes,
    region_rows,
    region_slots,
    region_step_from_block,
    sample_region_steps,
    unpack_region_lanes,
)
