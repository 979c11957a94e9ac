"""The benchmark harness of `flasht5_tpu_torch`: spec lookup, seeded inputs
and weights, the measured window, the profiler's trace, and the checks that
decide `correct`. Each cell's driver lives in `portbench/drivers/`."""
