"""Profiling tools: the phase timer, the trace aggregator and the harness."""
