"""Serving metrics used by the coordinator (SLO attainment, quantiles) and
the serving-system invariants checked after chaos runs."""

from repro_torch.sim.invariants import assert_invariants, check_invariants
