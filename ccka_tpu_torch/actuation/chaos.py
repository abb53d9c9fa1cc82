"""ChaosSink: seeded kubectl-edge fault injection over any ActuationSink.

The PyTorch port's form of `ccka_tpu/actuation/chaos.py`: a copy: the fates are drawn from the same
``random.Random(seed)`` sequence, command for command.

`ccka_tpu/faults` disturbs the simulated *world*; this module disturbs
the *actuation edge* — the four failure modes a controller daemon's
kubectl path actually exhibits and that the reference's apply-and-verify
scripts (`demo_20_offpeak_configure.sh:84-127`) were designed to survive:

- **timeout**: the command hangs past its budget (subprocess runner
  returns 124); the mutation never lands;
- **transient exit**: apiserver pressure / connection reset (rc != 0,
  no mutation) — the `_transient` family `sink._subprocess_runner`
  retries;
- **silent drop**: the command REPORTS success but the write is lost
  (a dropped patch behind a flaky admission chain) — only the skeptical
  read-back discipline catches this one;
- **admission rewrite**: a mutating webhook alters the patch before it
  lands (requirement value lists trimmed, consolidation settings
  clamped); the command succeeds and the read-back diverges from intent.

All injection draws come from ONE seeded host-side RNG in command order,
so a (sink, seed) pair is a reproducible chaos *realization*: two runs
sharing it — e.g. the kill/no-kill pair of the recovery scoreboard —
see identical failures as long as they issue identical commands. The
read paths (`observed_state`, `get_object`, read-backs) pass through
untouched: chaos models the write edge; the oracle must stay honest or
reconciliation could never terminate.

Disabled (or all-zero) chaos is a hard gate: the wrapper delegates
verbatim and draws NOTHING from its RNG — the zero-injection gate
`tests/test_recovery.py` pins a wrapped run command-for-command
identical to the bare sink.
"""

from __future__ import annotations

import copy
import random

from ccka_tpu_torch.config import CHAOS_PRESETS, ChaosConfig  # noqa: F401 (re-export)
from ccka_tpu_torch.actuation.sink import (ActuationSink, ManifestCommand,
                                     PatchCommand)


class ChaosSink(ActuationSink):
    """Wrap ``inner`` and inject seeded kubectl-edge failures on writes.

    Inherits the base apply-and-verify discipline (``apply_nodepool``,
    ``apply_manifest`` …), so failures fire exactly where a real
    kubectl's would: at the `_patch`/`_apply` hooks. ``stats`` counts
    injections per mode for the recovery scoreboard.
    """

    def __init__(self, inner: ActuationSink, chaos: ChaosConfig,
                 *, seed: int = 0):
        chaos.validate()
        self.inner = inner
        self.chaos = chaos
        self._rng = random.Random(seed)
        self._active = chaos.enabled and (
            chaos.timeout_prob + chaos.transient_exit_prob
            + chaos.drop_prob + chaos.rewrite_prob) > 0.0
        self.stats = {"commands": 0, "timeouts": 0, "transient_exits": 0,
                      "dropped": 0, "rewrites": 0}

    # -- injection core -----------------------------------------------------

    def _fate(self) -> str:
        """One draw decides this command's fate (probabilities stack in a
        fixed order so they partition [0, 1))."""
        c = self.chaos
        r = self._rng.random()
        if r < c.timeout_prob:
            return "timeout"
        r -= c.timeout_prob
        if r < c.transient_exit_prob:
            return "transient"
        r -= c.transient_exit_prob
        if r < c.drop_prob:
            return "drop"
        r -= c.drop_prob
        if r < c.rewrite_prob:
            return "rewrite"
        return "ok"

    def _rewrite_patch(self, cmd: PatchCommand) -> PatchCommand:
        """An admission-webhook-shaped mutation: trim the last value off
        each requirement value list (a webhook narrowing zones/capacity
        types), clamp consolidateAfter. The rewritten patch still
        *applies* cleanly — the divergence only shows at read-back."""
        patch = copy.deepcopy(cmd.patch)
        if cmd.patch_type == "merge":
            disruption = patch.get("spec", {}).get("disruption", {})
            if "consolidateAfter" in disruption:
                disruption["consolidateAfter"] = "300s"
            elif disruption:
                disruption["consolidationPolicy"] = "WhenEmpty"
        else:
            for oper in patch:
                value = oper.get("value")
                if isinstance(value, list):
                    for req in value:
                        vals = req.get("values")
                        if isinstance(vals, list) and len(vals) > 1:
                            req["values"] = vals[:-1]
        return PatchCommand(cmd.resource, cmd.name, cmd.patch_type, patch)

    # -- write hooks: fates fire here ---------------------------------------

    def _patch(self, cmd: PatchCommand) -> bool:
        if not self._active:
            return self.inner._patch(cmd)
        self.stats["commands"] += 1
        fate = self._fate()
        if fate == "timeout":
            self.stats["timeouts"] += 1
            return False
        if fate == "transient":
            self.stats["transient_exits"] += 1
            return False
        if fate == "drop":
            self.stats["dropped"] += 1
            return True          # the lie: reported ok, never forwarded
        if fate == "rewrite":
            self.stats["rewrites"] += 1
            return self.inner._patch(self._rewrite_patch(cmd))
        return self.inner._patch(cmd)

    def _apply(self, cmd: ManifestCommand) -> bool:
        if not self._active:
            return self.inner._apply(cmd)
        self.stats["commands"] += 1
        fate = self._fate()
        if fate == "timeout":
            self.stats["timeouts"] += 1
            return False
        if fate == "transient":
            self.stats["transient_exits"] += 1
            return False
        if fate == "drop":
            self.stats["dropped"] += 1
            return True
        # Manifests have no requirement lists to trim; a rewrite fate
        # degrades to a transient failure rather than silently passing.
        if fate == "rewrite":
            self.stats["transient_exits"] += 1
            return False
        return self.inner._apply(cmd)

    # -- read paths: always honest ------------------------------------------

    def _readback_ok(self, pool: str, path_prefix: str) -> bool:
        return self.inner._readback_ok(pool, path_prefix)

    def _dump(self, pool: str) -> str:
        return self.inner._dump(pool)

    def observed_state(self, pool: str) -> dict:
        return self.inner.observed_state(pool)

    def get_object(self, kind: str, name: str, *,
                   namespace: str = "") -> dict:
        return self.inner.get_object(kind, name, namespace=namespace)

    def list_objects(self, kind: str, *, selector: str = "",
                     namespace: str = "") -> list[dict]:
        return self.inner.list_objects(kind, selector=selector,
                                       namespace=namespace)


def make_chaos_sink(inner: ActuationSink, intensity: str | ChaosConfig,
                    *, seed: int = 0) -> ChaosSink:
    """ChaosSink from a named intensity (`config.CHAOS_PRESETS`) or an
    explicit ChaosConfig; unknown names are rejected up front — the
    chaos-eval convention."""
    if isinstance(intensity, str):
        if intensity not in CHAOS_PRESETS:
            raise ValueError(f"unknown chaos intensity {intensity!r}; "
                             f"presets: {sorted(CHAOS_PRESETS)}")
        intensity = CHAOS_PRESETS[intensity]
    return ChaosSink(inner, intensity, seed=seed)
