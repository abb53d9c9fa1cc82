"""ccka_tpu_torch.obs — run traces, incidents and the device-time
observatory, the PyTorch form of `ccka_tpu/obs/`:

- `obs.trace` — nested span tracer with device fences; Chrome trace-event
  (Perfetto) + JSONL export; the span-backed StageTimer.
- `obs.compile` — call and CUDA-graph capture counters for hot entry
  points (the rollout modes, MPC replans, fleet and service ticks), with
  hot-path recapture warnings.
- `obs.runlog` — structured JSONL run logs for the training entry
  points and `obs tail|summarize`, with the declared event-name
  registry.
- `obs.recorder` — the per-tenant flight recorder: bounded ring buffers
  of recent control-surface rows, dumped as checksummed captures when an
  incident trigger fires.
- `obs.incidents` — the trigger vocabulary, incident records and the
  causal timeline join (`incidents list|show|timeline`).
- `obs.burnrate` — fast+slow-window SLO burn rates behind the
  `ccka_slo_burn_rate` / `ccka_incident_active` gauges.
- `obs.bench_history` — BENCH_r*.json + lane_times.json as one schema'd
  series with the regression diff (`bench-diff`) and the weak-scaling
  curve (`scaling-curve`).
- `obs.costmodel` — analytic cost attribution: the rollout kernels'
  bytes and operations counted from their shapes, the card's rates and
  roofline bounds, the program registry (counts, measured peak memory)
  joined with the dispatch counters, achieved-roofline fractions and
  the bandwidth probe behind `perf`.
- `obs.occupancy` — the pipeline occupancy ledger: fenced per-stage
  (generation/kernel/host) and per-shard timings, with the max/mean
  shard imbalance.
- `obs.decisions` — decision provenance: per-tick objective-term
  attribution, the rule-shadow counterfactual, divergence drift and the
  `policy_divergence` trigger behind `decisions list|show|explain`.
- `obs.tournament` — the shadow tournament's ledger and audits.
"""

from ccka_tpu_torch.obs.bench_history import (  # noqa: F401
    bench_diff,
    load_bench_history,
    scaling_curve,
    write_scaling_csv,
)
from ccka_tpu_torch.obs.burnrate import (  # noqa: F401
    BurnRate,
    BurnRateEngine,
)
from ccka_tpu_torch.obs.compile import (  # noqa: F401
    CompileStats,
    compile_report,
    stats_for,
    watch_jit,
)
from ccka_tpu_torch.obs.costmodel import (  # noqa: F401
    ProgramRecord,
    achieved_roofline_fraction,
    attribute,
    crosscheck_bytes,
    pipeline_snapshot,
    program_table,
    publish_pipeline_snapshot,
    rollout_cost,
    total_dispatches,
)
from ccka_tpu_torch.obs.occupancy import (  # noqa: F401
    PIPELINE_STAGES,
    OccupancyLedger,
    measure_packed_pipeline,
    measure_shard_times,
    shard_imbalance,
)
from ccka_tpu_torch.obs.decisions import (  # noqa: F401
    DECISION_COLS,
    TERM_NAMES,
    DecisionLedger,
    decision_row_layout,
    explain_row,
    objective_terms,
    read_decisions,
    shadow_decision_columns,
    term_shares,
)
from ccka_tpu_torch.obs.incidents import (  # noqa: F401
    TRIGGERS,
    Incident,
    IncidentLog,
    build_timeline,
    read_incidents,
)
from ccka_tpu_torch.obs.recorder import (  # noqa: F401
    FlightRecorder,
    verify_dump,
)
from ccka_tpu_torch.obs.runlog import (  # noqa: F401
    RUNLOG_EVENTS,
    RunLog,
    read_runlog,
    summarize_runlog,
)
from ccka_tpu_torch.obs.trace import (  # noqa: F401
    Span,
    SpanTracer,
    StageTimer,
    validate_chrome_trace,
)
