"""The general code of the benchmark: the manifest, the yardstick (peaks,
bounds, work arithmetic), seeded inputs, the profiler's reading, and the
two drivers (training and serving)."""
