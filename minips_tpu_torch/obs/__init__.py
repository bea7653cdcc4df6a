"""Observability pieces carried over from ``minips_tpu/obs`` (so far the
log2 latency histograms that ``utils/timing.py`` reads)."""
