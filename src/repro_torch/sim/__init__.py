"""Cluster-scale simulation plane: traces, metrics, monolithic baselines,
and the serving-system invariants checked after chaos runs."""

from repro_torch.sim.invariants import assert_invariants, check_invariants
from repro_torch.sim.metrics import (
    RequestRecord,
    executor_seconds,
    goodput,
    latency_cdf,
    mean_fleet_size,
    mean_latency,
    percentile_latency,
    quantile,
    slo_attainment,
)
from repro_torch.sim.monolithic import MonolithicSystem, WorkflowSpec
from repro_torch.sim.trace import TraceRequest, diurnal_trace, gamma_interarrivals, generate_trace
