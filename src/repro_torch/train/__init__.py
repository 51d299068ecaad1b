"""The training loop (port of ``repro.train``)."""
