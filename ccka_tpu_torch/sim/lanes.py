"""Row arithmetic of the packed ``[T_pad, rows, B]`` exo stream, and the
registries of lane generators and policy modes.

The PyTorch form of `ccka_tpu/sim/lanes.py`. A packed
stream is the base exo block, then one optional row block per lane
family, in the order of :data:`LANE_FAMILIES`. Every consumer (the
rollout kernels' entries, the lane synthesizers, the unpackers) reads
its layout from the row count alone, through :func:`resolve_layout`.

The three built-in families are a plain table here: (name, rows(Z), key
tag). Their block sizes are chosen so that every subset of families gives
a different total at every zone count of :data:`_AMBIGUITY_ZS`, which is
what lets the row count name the layout. The fault and workload blocks
are synthesized by the signal sources and read by the rollout kernels;
the region block is synthesized through :func:`lane_generator` (its
generator lives in `regions/process.py`) and read by the geo overlay
(`regions/geo.py`), while the kernels stride past it.

Each family may also supply a traced-parameter generator
(:func:`lane_param_generator`): the same block for S cells of scenario
parameters on shared draws, which the scenario axis of `search/axis.py`
drives. Further families register through :func:`register_lane_family`
(a name, its rows, a unique key tag; refused when a row count would name
two layouts) and get their generator from :func:`provide_lane_generator`.
The policy-mode registry (:func:`register_mode`, :func:`mode_engine`)
holds each packed mode's engine entries; the four built-in modes register
in `sim/megakernel.py`, their mesh engines in
`parallel/sharded_kernel.py`.

Block sizes (each padded to a multiple of 8 rows):

    exo_rows(Z)       spot[Z], od[Z], carbon[Z], demand[2], is_peak
    fault_rows(Z)     hazard[Z], deny, delay, stale
    workload_rows(Z)  inference, batch and background arrivals; sized
                      fault_rows(Z) + 8 so the layouts stay distinct
    region_rows(Z)    4 * fault_rows(Z) + 32, more than all others
"""

from __future__ import annotations

import importlib
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


# The registered families in stream order (the built-in three first);
# rebound, never mutated, by register_lane_family / unregister_lane_family.
LANE_FAMILIES = (
    LaneFamily("faults", fault_rows, 0xFA117),
    LaneFamily("workloads", workload_rows, 0x301AD),
    LaneFamily("regions", region_rows, 0x6E0),
)
_BUILTIN_FAMILIES = tuple(f.name for f in LANE_FAMILIES)
FAULT_KEY_TAG = LANE_FAMILIES[0].key_tag
WORKLOAD_KEY_TAG = LANE_FAMILIES[1].key_tag
REGION_KEY_TAG = LANE_FAMILIES[2].key_tag

# Zone counts at which every subset of families must total a distinct row
# count: the presets' (default Z=3, multiregion Z=4) and the spread a
# scenario suite could configure.
_AMBIGUITY_ZS = (1, 2, 3, 4, 5, 6, 8)

# Families whose blocks the signal sources synthesize through a generator
# supplied by another module (the built-in two are synthesized inline):
# name -> the module that supplies it, imported on first use.
_PROVIDERS = {"regions": "ccka_tpu_torch.regions.process"}
_GENERATORS: dict = {}


def register_lane_family(name: str, *, rows, key_tag: int,
                         provider: str | None = None) -> LaneFamily:
    """Register a packed-stream lane family after the present ones.
    ``rows`` is a ``Z -> row count`` callable; ``key_tag`` the family's
    seed tag (unique: two families on one tag would draw the same
    numbers); ``provider`` an optional module imported when the family's
    generator is first needed. Refuses a duplicate name or tag, and any
    family that would make two subsets of families total one row count
    at a zone count of :data:`_AMBIGUITY_ZS`; the registry is unchanged
    after a refusal."""
    global LANE_FAMILIES
    if name in {f.name for f in LANE_FAMILIES}:
        raise ValueError(f"lane family {name!r} already registered")
    if key_tag in {f.key_tag for f in LANE_FAMILIES}:
        raise ValueError(f"lane family {name!r}: key tag {key_tag:#x} "
                         "already registered to another family")
    fam = LaneFamily(name, rows, key_tag)
    trial = LANE_FAMILIES + (fam,)
    for z in _AMBIGUITY_ZS:
        _subset_sums(z, trial)   # raises on a collision
    LANE_FAMILIES = trial
    if provider is not None:
        _PROVIDERS[name] = provider
    return fam


def unregister_lane_family(name: str) -> None:
    """Remove a registered family and its generators (for tests that
    register a throwaway family; the built-in families stay)."""
    global LANE_FAMILIES
    if name in _BUILTIN_FAMILIES:
        raise ValueError(f"lane family {name!r} is built in")
    LANE_FAMILIES = tuple(f for f in LANE_FAMILIES if f.name != name)
    for table in (_GENERATORS, _PARAM_GENERATORS, _PROVIDERS):
        table.pop(name, None)


def _generated() -> list:
    """Families synthesized through a supplied generator: every
    registered family but the two the sources synthesize inline."""
    return sorted(f.name for f in LANE_FAMILIES
                  if f.name not in ("faults", "workloads"))


def provide_lane_generator(name: str, generate) -> None:
    """Attach the synthesis function of family ``name`` (called by the
    module that owns the family when it is imported). ``generate(config,
    generator, steps, t_pad, Z, batch, *, ctx, out)`` writes the
    ``[t_pad, rows(Z), B]`` block into ``out``; ``ctx`` holds the stream's
    clock (``dt_s``, ``start_unix_s``, ``start_offset_s``). A second,
    different function for one family is refused."""
    if name not in _generated():
        raise ValueError(f"lane family {name!r} takes no generator; "
                         f"have {_generated()}")
    have = _GENERATORS.get(name)
    if have is not None and have is not generate:
        raise ValueError(f"lane family {name!r} already has a generator")
    _GENERATORS[name] = generate


def lane_generator(name: str):
    """The synthesis function of family ``name``, importing the module
    that supplies it on first use."""
    if name not in _generated():
        raise ValueError(f"lane family {name!r} takes no generator; "
                         f"have {_generated()}")
    if name not in _GENERATORS and name in _PROVIDERS:
        importlib.import_module(_PROVIDERS[name])
    if name not in _GENERATORS:
        raise ValueError(f"lane family {name!r} has no registered "
                         "generator (provide_lane_generator)")
    return _GENERATORS[name]


# The traced-parameter synthesis of each family (the scenario axis of
# `search/axis.py`): name -> the module that supplies it. A family not
# listed has no such generator and is synthesized constant across cells.
_PARAM_PROVIDERS = {"faults": "ccka_tpu_torch.faults.process",
                    "workloads": "ccka_tpu_torch.workloads.process",
                    "regions": "ccka_tpu_torch.regions.process"}
_PARAM_GENERATORS: dict = {}


def provide_lane_param_generator(name: str, generate_p) -> None:
    """Attach the traced-parameter synthesis function of family ``name``
    (called by the module that owns the family when it is imported).
    ``generate_p(config, derived, generator, steps, t_pad, Z, batch, *,
    ctx, out)`` draws the family's latents at the inner width ``batch``
    and writes the ``[t_pad, rows(Z), S, batch]`` block of S cells into
    ``out``, cell s from ``derived`` (`search/params.py::ScenarioParams.
    derived()[name]`, float32 [S] arrays) with every cell on the same
    draws. A second, different function for one family is refused."""
    if name not in {f.name for f in LANE_FAMILIES}:
        raise ValueError(f"unknown lane family {name!r}; registered: "
                         f"{sorted(f.name for f in LANE_FAMILIES)}")
    have = _PARAM_GENERATORS.get(name)
    if have is not None and have is not generate_p:
        raise ValueError(f"lane family {name!r} already has a param "
                         "generator")
    _PARAM_GENERATORS[name] = generate_p


def lane_param_generator(name: str):
    """The traced-parameter synthesis function of family ``name``,
    importing the module that supplies it on first use; None for a
    family that has none (unknown names raise)."""
    if name not in {f.name for f in LANE_FAMILIES}:
        raise ValueError(f"unknown lane family {name!r}; registered: "
                         f"{sorted(f.name for f in LANE_FAMILIES)}")
    if name not in _PARAM_GENERATORS and name in _PARAM_PROVIDERS:
        importlib.import_module(_PARAM_PROVIDERS[name])
    return _PARAM_GENERATORS.get(name)


def _subset_sums(Z: int, families=None) -> dict[int, tuple[str, ...]]:
    """{total rows: the families present} over every subset of
    ``families`` (default the registered ones), in table order; raises
    when two subsets total one row count."""
    families = LANE_FAMILIES if families is None else families
    sums: dict[int, tuple[str, ...]] = {}
    for r in range(len(families) + 1):
        for combo in itertools.combinations(families, r):
            total = exo_rows(Z) + sum(f.rows(Z) for f in combo)
            if total in sums:
                raise ValueError(
                    f"ambiguous lane layout at Z={Z}: families "
                    f"{tuple(f.name for f in combo)} and {sums[total]} "
                    f"both total {total} rows; a stream could not be "
                    "resolved from its row count")
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


# ---- time-axis blocks and cluster-axis chunks (sim/streaming.py) ----------
#
# The streaming rollout splits the packed stream's time axis into fixed
# blocks (synthesis of block k+1 overlaps the kernel on block k) and a
# fleet's cluster axis into equal chunks. The port's kernels have no time
# chunk: ``t_chunk`` is kept in these signatures so that the port accepts
# and refuses exactly the splits the JAX package does.

BLOCK_KEY_TAG = 0x5B10C  # the per-block seed tag of block synthesis


def block_layout(T: int, block_T: int, t_chunk: int) -> tuple[int, int]:
    """``(n_blocks, T_pad)`` of a time-blocked stream covering ``T`` true
    ticks in fixed ``block_T``-tick blocks of ``t_chunk``-tick chunks.
    Rejects a block that is not a whole number of chunks, and a padded
    horizon that is not a whole number of blocks (the double buffer holds
    two blocks of one shape)."""
    if block_T <= 0 or t_chunk <= 0:
        raise ValueError(f"block_T={block_T} / t_chunk={t_chunk} must "
                         "be positive")
    if block_T % t_chunk:
        raise ValueError(
            f"block_T={block_T} is not a t_chunk={t_chunk} multiple — "
            "the kernel grid advances whole time chunks")
    T_pad = math.ceil(T / t_chunk) * t_chunk
    if T_pad % block_T:
        raise ValueError(
            f"block_T={block_T} does not divide the padded horizon "
            f"T_pad={T_pad} (T={T}, t_chunk={t_chunk}) — streaming "
            "blocks must tile the horizon exactly")
    return T_pad // block_T, T_pad


def chunk_layout(batch: int, chunk: int) -> int:
    """Number of cluster-axis chunks of ``chunk`` clusters in a
    ``batch``-wide fleet. Rejects a chunk that does not divide the batch:
    a ragged last chunk would be another launch geometry."""
    if chunk <= 0:
        raise ValueError(f"cluster chunk={chunk} must be positive")
    if batch % chunk:
        raise ValueError(
            f"cluster chunk={chunk} does not divide batch={batch} — "
            "cluster-axis chunking needs equal-width chunks")
    return batch // chunk


def block_bytes(block_T: int, rows: int, batch: int) -> int:
    """float32 bytes of one stream block, the unit of the streaming
    pipeline's memory bound (two blocks live)."""
    return 4 * block_T * rows * batch


# ---- policy-mode registry ---------------------------------------------------
#
# A packed policy mode is a named bundle of engine entries over one stream
# layout: ``packed_summary`` (the whole-stream entry, `sim/megakernel.py::
# packed_mode_summary`) and ``block_summary`` (the carried-state closures of
# `packed_mode_block_summary_fn`). `sim/megakernel.py` registers the four
# built-in modes and dispatches through here. The port has no separate
# reference engine: a CPU stream runs the plain version inside the same
# entries. ``sharded_block_summary`` (the carried-state closures over a
# device mesh) is filled by `parallel/sharded_kernel.py`.

_ENGINE_PROVIDERS = {
    "packed_summary": "ccka_tpu_torch.sim.megakernel",
    "block_summary": "ccka_tpu_torch.sim.megakernel",
    "sharded_block_summary": "ccka_tpu_torch.parallel.sharded_kernel",
}
_MODE_REGISTRAR = "ccka_tpu_torch.sim.megakernel"


class EngineMode:
    """One registered packed policy mode and its engine entries (None
    until a module provides them)."""

    __slots__ = ("name", "packed_summary", "block_summary",
                 "sharded_block_summary")

    def __init__(self, name: str):
        self.name = name
        for slot in _ENGINE_PROVIDERS:
            setattr(self, slot, None)


MODES: dict[str, EngineMode] = {}


def register_mode(name: str, **engines) -> EngineMode:
    """Register a packed policy mode with its engine entries (a second
    registration of a name is refused)."""
    if name in MODES:
        raise ValueError(f"packed mode {name!r} already registered")
    MODES[name] = EngineMode(name)
    for slot, fn in engines.items():
        provide_mode_engine(name, slot, fn)
    return MODES[name]


def unregister_mode(name: str) -> None:
    """Remove a mode (for tests that register a throwaway mode)."""
    MODES.pop(name, None)


def provide_mode_engine(name: str, slot: str, fn) -> None:
    """Attach one engine entry to a registered mode; a filled slot is not
    filled again."""
    if slot not in _ENGINE_PROVIDERS:
        raise ValueError(f"unknown engine slot {slot!r}; have "
                         f"{sorted(_ENGINE_PROVIDERS)}")
    mode = resolve_mode(name)
    if getattr(mode, slot) is not None:
        raise ValueError(f"mode {name!r} already has a {slot} engine")
    setattr(mode, slot, fn)


def mode_names() -> tuple[str, ...]:
    """The registered mode names (the built-in four register when
    `sim/megakernel.py` is imported, which this does first)."""
    if not MODES:
        importlib.import_module(_MODE_REGISTRAR)
    return tuple(MODES)


def resolve_mode(name: str) -> EngineMode:
    """The registered mode ``name``; an unknown name raises with the
    registered vocabulary."""
    if name not in MODES:
        importlib.import_module(_MODE_REGISTRAR)
    if name not in MODES:
        raise ValueError(f"unknown packed mode {name!r} — have "
                         f"{tuple(MODES)}")
    return MODES[name]


def mode_engine(name: str, slot: str):
    """The engine entry of mode ``name`` for ``slot``, importing the
    slot's provider on first use. A mode without it raises, naming both:
    no other engine stands in."""
    mode = resolve_mode(name)
    if slot not in _ENGINE_PROVIDERS:
        raise ValueError(f"unknown engine slot {slot!r}; have "
                         f"{sorted(_ENGINE_PROVIDERS)}")
    fn = getattr(mode, slot)
    if fn is None:
        importlib.import_module(_ENGINE_PROVIDERS[slot])
        fn = getattr(mode, slot)
    if fn is None:
        raise ValueError(f"packed mode {name!r} has no {slot} engine "
                         "registered")
    return fn
