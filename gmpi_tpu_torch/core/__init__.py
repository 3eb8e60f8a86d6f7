"""gmpi_tpu_torch.core — see the package docstring."""
