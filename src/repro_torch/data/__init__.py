"""Synthetic CTR data and metrics (numpy copies of ``repro.data``)."""
