"""Utilities: structured logging, profiling counters, numeric guards."""

from monte_carlo_gp.utils.profiling import Phase, phase_report  # noqa: F401
