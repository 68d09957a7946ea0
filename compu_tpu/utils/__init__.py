"""Observability and shared utilities.

The reference is ``no_std`` and has no tracing/metrics at all (SURVEY §5);
these are additive subsystems: per-block throughput counters
and JAX profiler trace annotation helpers.
"""

from .metrics import Metrics, trace_span  # noqa: F401
