"""Metric readers, one module a metric, found by the metric's name in BENCHMARK.json."""
