"""Shared utilities (profiling/observability)."""

from .profiling import Profiler, profiler

__all__ = ["Profiler", "profiler"]
