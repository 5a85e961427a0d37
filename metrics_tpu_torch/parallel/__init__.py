"""Distributed pieces of the port (port of ``metrics_tpu/parallel``); so far
only the quantized-sync constants the engine's at-rest codec shares."""
