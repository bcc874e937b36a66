"""Serving metrics used by the coordinator (SLO attainment, quantiles)."""
