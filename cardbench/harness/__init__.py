"""The benchmark harness: spec, traffic, the window, the trace, the check."""
