"""Observability: the span tracer the executors report to."""
