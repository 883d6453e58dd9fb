"""Typed per-step, per-component HBM-byte ledger for the serving engine.

The paper's whole argument is a bandwidth-utilization ledger: distribute
off-chip link activity evenly across time and nothing starves.  Before this
module, the repo's byte accounting was scattered — hand-maintained dict
literals in `serving/engine.py`, schema-parity zero dicts hand-synced in
`serving/dense_engine.py`, ad-hoc tallies in `benchmarks/run.py`.  The
ledger is the single typed source of truth:

  * `STEP_SCHEMA` is THE per-step metrics schema.  Both engines emit rows
    through `BandwidthLedger.record`, which zero-fills missing fields,
    derives the composites, and rejects unknown keys — schema drift between
    the engines is now a constructor error, not a silently diverging dict.
  * Byte components per step: `param_bytes` (the weight stream — the
    paper's "rewrite" traffic), `kv_write_bytes` / `kv_read_bytes` (KV
    traffic proportional to processed/visible tokens), the two
    attention-read paths (`attn_bytes_gather` materialized vs
    `attn_bytes_stream` streamed by the kernel's ring), plus the two savings
    columns: `prefix_saved_bytes` (KV writes the radix cache skipped) and
    `spec_saved_bytes` (weight streams amortized by accepted draft tokens).
  * The composite `hbm_bytes = param_bytes + kv_write_bytes + kv_read_bytes`
    reproduces the previous hand-built projection exactly (regression-
    tested in tests/test_obs.py), so the BENCH_serving.json trajectory
    stays comparable across PRs.

Memory is bounded: `retention > 0` keeps only the most recent N rows as a
ring; evicted rows fold into a running `rollup` (summed numeric fields +
step count), and `totals()` always covers the engine's full lifetime —
long serving runs stop growing per step while aggregate byte accounting
stays exact.  `retention == 0` (the default) retains everything, which is
what the existing tests/benchmarks slice into.

`utilization_report()` is the paper-facing column: the measured
distribution of per-step link activity (mean/peak of `hbm_bytes`, plus its
CoV — 1.0 means perfectly flat, the GPP ideal) next to the utilization the
cycle-accurate GPP simulator (`core.simulator.simulate_gpp`, the port's
copy) predicts for a matched rewrite:compute ratio.  A copy of
`repro.obs.ledger`.
"""
from __future__ import annotations

import statistics
from collections import deque

# THE per-step metrics schema, shared by ServingEngine and
# DenseServingEngine (tests/test_obs.py asserts both emit exactly this).
STEP_SCHEMA: "tuple[str, ...]" = (
    # step composition (token counts)
    "step", "tokens", "prefill_tokens", "prefill_real_tokens",
    "decode_tokens", "verify_tokens", "drafted_tokens", "accepted_tokens",
    "acceptance_rate",
    # pool / queue state
    "blocks_in_use", "free_blocks", "queue_depth", "preempted",
    "prefix_hit_tokens", "blocks_shared",
    # HBM byte components (the ledger proper)
    "param_bytes", "kv_write_bytes", "kv_read_bytes",
    "prefix_saved_bytes", "spec_saved_bytes",
    "hbm_bytes", "attn_bytes_gather", "attn_bytes_stream",
    # wall time of the step (us; 0.0 when telemetry is disabled)
    "step_wall_us",
)

_SCHEMA_SET = frozenset(STEP_SCHEMA)


def step_row(**fields) -> dict:
    """One schema-complete step row: zero-fill, derive, reject unknowns.

    Derived when not explicitly passed:
      acceptance_rate = accepted/drafted (0 when nothing drafted)
      hbm_bytes       = param_bytes + kv_write_bytes + kv_read_bytes
      spec_saved_bytes = accepted_tokens * param_bytes (each accepted draft
                         token is one decode step's weight stream avoided)
    """
    unknown = set(fields) - _SCHEMA_SET
    if unknown:
        raise ValueError(f"unknown step-metric fields: {sorted(unknown)} "
                         f"(schema: {STEP_SCHEMA})")
    row = {k: 0 for k in STEP_SCHEMA}
    row["acceptance_rate"] = 0.0
    row["step_wall_us"] = 0.0
    row.update(fields)
    if "acceptance_rate" not in fields and row["drafted_tokens"]:
        row["acceptance_rate"] = row["accepted_tokens"] / row["drafted_tokens"]
    if "hbm_bytes" not in fields:
        row["hbm_bytes"] = (row["param_bytes"] + row["kv_write_bytes"]
                            + row["kv_read_bytes"])
    if "spec_saved_bytes" not in fields:
        row["spec_saved_bytes"] = row["accepted_tokens"] * row["param_bytes"]
    return row


class BandwidthLedger:
    """List-compatible bounded step-metrics store (see module docstring).

    Supports the access patterns the existing tests/benchmarks use on the
    old plain list — truthiness, len, iteration, int/slice indexing — so
    `engine.metrics` keeps its contract while gaining typed rows, bounded
    retention, and lifetime totals.
    """

    SCHEMA = STEP_SCHEMA

    def __init__(self, retention: int = 0):
        if retention < 0:
            raise ValueError("retention >= 0 (0 = unbounded)")
        self.retention = retention
        self._rows: "deque[dict]" = deque()
        self.rollup: "dict[str, float]" = {}   # sums over EVICTED rows
        self.rolled_up_steps = 0
        self.steps = 0                         # lifetime row count

    # ------------------------------------------------------------ record
    def record(self, **fields) -> dict:
        row = step_row(step=self.steps, **fields)
        self.steps += 1
        self._rows.append(row)
        if self.retention and len(self._rows) > self.retention:
            evicted = self._rows.popleft()
            for k, v in evicted.items():
                if k != "step":
                    self.rollup[k] = self.rollup.get(k, 0) + v
            self.rolled_up_steps += 1
        return row

    def append(self, row: dict) -> None:
        """Accept a pre-built row (must already be schema-complete)."""
        missing = _SCHEMA_SET - set(row)
        if missing:
            raise ValueError(f"row missing schema fields: {sorted(missing)}")
        self.record(**{k: row[k] for k in row if k != "step"})

    # --------------------------------------------------- list compatibility
    def __len__(self) -> int:
        return len(self._rows)

    def __bool__(self) -> bool:
        return bool(self._rows)

    def __iter__(self):
        return iter(self._rows)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._rows)[idx]
        return self._rows[idx]

    # ------------------------------------------------------------- sums
    def total(self, key: str) -> float:
        """Lifetime sum of a numeric field: retained rows + rollup."""
        if key not in _SCHEMA_SET:
            raise KeyError(key)
        return self.rollup.get(key, 0) + sum(r[key] for r in self._rows)

    def totals(self) -> dict:
        return {k: self.total(k) for k in STEP_SCHEMA if k != "step"}

    # ------------------------------------------------------ paper column
    def utilization_report(self, *, sim_macros: int = 32,
                           sim_rounds: int = 8) -> dict:
        """Measured vs simulate_gpp-predicted link-utilization summary.

        measured_bw_utilization  mean/peak of per-step hbm_bytes over the
                                 retained window — 1.0 means every step
                                 moves the same bytes (perfectly flat, the
                                 GPP ideal); prefill bursts push it down.
        hbm_bytes_per_step_cov   the same flatness as a CoV (0 = flat).
        predicted_bw_utilization bus-busy fraction of the cycle-accurate
                                 GPP simulator at a rewrite:compute ratio
                                 matched to the measured step composition
                                 (weight-stream bytes : total step bytes).
        """
        hbm = [float(r["hbm_bytes"]) for r in self._rows]
        if not hbm or max(hbm) <= 0:
            return {"measured_bw_utilization": 0.0,
                    "predicted_bw_utilization": 0.0,
                    "hbm_bytes_per_step_cov": 0.0,
                    "steps_measured": len(hbm)}
        measured = (sum(hbm) / len(hbm)) / max(hbm)
        mean = sum(hbm) / len(hbm)
        cov = statistics.pstdev(hbm) / mean if mean else 0.0

        from repro_torch.core.analytical import PimConfig
        from repro_torch.core.simulator import simulate_gpp

        # map the measured step composition onto the paper's knobs: the
        # weight stream is the "rewrite", everything else the compute-side
        # traffic; t_pim/t_rw = ratio  =>  n_in = ratio * size_ou / s.
        params = self.total("param_bytes") / self.steps if self.steps else 0
        ratio = max(0.125, (mean - params) / params) if params else 1.0
        cfg = PimConfig()
        cfg = cfg.with_(n_in=max(1.0, ratio * cfg.size_ou / cfg.s))
        sim = simulate_gpp(cfg, sim_macros, sim_rounds)
        predicted = (sim.bw_busy_cycles / sim.total_cycles
                     if sim.total_cycles else 0.0)
        return {"measured_bw_utilization": measured,
                "predicted_bw_utilization": predicted,
                "hbm_bytes_per_step_cov": cov,
                "steps_measured": len(hbm)}

    def summary(self) -> dict:
        """Aggregate export unit for metrics snapshots."""
        out = {"steps": self.steps,
               "rolled_up_steps": self.rolled_up_steps,
               "retention": self.retention}
        out.update({f"total_{k}": self.total(k) for k in (
            "tokens", "prefill_tokens", "decode_tokens", "verify_tokens",
            "drafted_tokens", "accepted_tokens", "prefix_hit_tokens",
            "param_bytes", "kv_write_bytes", "kv_read_bytes",
            "prefix_saved_bytes", "spec_saved_bytes", "hbm_bytes",
            "attn_bytes_gather", "attn_bytes_stream")})
        out.update(self.utilization_report())
        return out
