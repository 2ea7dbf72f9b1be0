"""One reader a per-layer metric, `<metric name>.py`, found by the name in
`BENCHMARK.json`: `read(ctx)` returns the number, or None where it finds
nothing to read."""
