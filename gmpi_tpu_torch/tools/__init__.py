"""Measurement scripts of the port, run with ``python -m gmpi_tpu_torch.tools.<name>``."""
