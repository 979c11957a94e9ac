"""Utilities: tracing, timing and speed-of-light accounting
(`utils.profiling`)."""
