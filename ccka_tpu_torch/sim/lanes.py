"""Row arithmetic of the packed ``[T_pad, rows, B]`` exo stream.

The PyTorch form of the layout half of `ccka_tpu/sim/lanes.py`. A packed
stream is the base exo block, then one optional row block per lane
family, in the order of :data:`LANE_FAMILIES`. Every consumer (the
rollout kernels' entries, the lane synthesizers, the unpackers) reads
its layout from the row count alone, through :func:`resolve_layout`.

The three built-in families are a plain table here: (name, rows(Z), key
tag). Their block sizes are chosen so that every subset of families gives
a different total for any zone count, which is what lets the row count
name the layout. The region family (``region_rows``) resolves and rides a
stream but nothing in the port consumes or synthesizes it yet.

Block sizes (each padded to a multiple of 8 rows):

    exo_rows(Z)       spot[Z], od[Z], carbon[Z], demand[2], is_peak
    fault_rows(Z)     hazard[Z], deny, delay, stale
    workload_rows(Z)  inference, batch and background arrivals; sized
                      fault_rows(Z) + 8 so the layouts stay distinct
    region_rows(Z)    4 * fault_rows(Z) + 32, more than all others
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple


def exo_rows(Z: int) -> int:
    """Rows of the base exo block: spot[Z] + od[Z] + carbon[Z] + demand[2]
    + is_peak, padded to a multiple of 8."""
    return math.ceil((3 * Z + 3) / 8) * 8


def fault_rows(Z: int) -> int:
    """Rows of the fault block: hazard[Z] + deny + delay + stale, padded
    to a multiple of 8."""
    return math.ceil((Z + 3) / 8) * 8


def workload_rows(Z: int) -> int:
    """Rows of the workload block (3 used): ``fault_rows(Z) + 8``, so that
    a row count never names two layouts."""
    return fault_rows(Z) + 8


def region_rows(Z: int) -> int:
    """Rows of the region block: ``4 * fault_rows(Z) + 32``, more than the
    other blocks together."""
    return 4 * fault_rows(Z) + 32


class LaneFamily(NamedTuple):
    name: str
    rows: object   # Z -> row count
    key_tag: int   # the family's seed tag in stream synthesis


LANE_FAMILIES = (
    LaneFamily("faults", fault_rows, 0xFA117),
    LaneFamily("workloads", workload_rows, 0x301AD),
    LaneFamily("regions", region_rows, 0x6E0),
)
FAULT_KEY_TAG = LANE_FAMILIES[0].key_tag
WORKLOAD_KEY_TAG = LANE_FAMILIES[1].key_tag


def _subset_sums(Z: int) -> dict[int, tuple[str, ...]]:
    """{total rows: the families present} over every subset of families,
    in table order."""
    sums: dict[int, tuple[str, ...]] = {}
    for r in range(len(LANE_FAMILIES) + 1):
        for combo in itertools.combinations(LANE_FAMILIES, r):
            total = exo_rows(Z) + sum(f.rows(Z) for f in combo)
            if total in sums:  # the block sizes above rule this out
                raise AssertionError(f"ambiguous lane layout at Z={Z}")
            sums[total] = tuple(f.name for f in combo)
    return sums


class StreamLayout(NamedTuple):
    """The lane layout of one packed stream: the families present and the
    row range of each block."""

    Z: int
    rows: int
    families: tuple     # names present, in table order
    offsets: dict       # name -> (lo, hi)

    def has(self, name: str) -> bool:
        return name in self.families

    def block(self, name: str) -> tuple[int, int]:
        if name not in self.offsets:
            raise ValueError(f"stream carries no {name} lanes")
        return self.offsets[name]


def resolve_layout(rows: int, Z: int) -> StreamLayout:
    """The layout a stream of ``rows`` rows has at zone count ``Z``.
    Raises on a row count no subset of families gives: a half-widened
    stream would otherwise read lanes as padding."""
    sums = _subset_sums(Z)
    names = sums.get(int(rows))
    if names is None:
        valid = ", ".join(f"{total} ({'+'.join(combo) or 'plain'})"
                          for total, combo in sorted(sums.items()))
        raise ValueError(f"packed stream has {rows} rows; this topology "
                         f"(Z={Z}) expects one of: {valid}")
    offsets = {}
    off = exo_rows(Z)
    for fam in LANE_FAMILIES:
        if fam.name in names:
            offsets[fam.name] = (off, off + fam.rows(Z))
            off += fam.rows(Z)
    return StreamLayout(Z, int(rows), names, offsets)


def stream_layout(rows: int, Z: int) -> tuple[bool, bool]:
    """``(has_faults, has_workloads)`` of a stream of ``rows`` rows."""
    lay = resolve_layout(rows, Z)
    return lay.has("faults"), lay.has("workloads")


def workload_base(rows: int, Z: int) -> int:
    """First row of the workload block (after the fault block when there
    is one)."""
    lay = resolve_layout(rows, Z)
    if not lay.has("workloads"):
        raise ValueError("stream carries no workload lanes")
    return lay.block("workloads")[0]
