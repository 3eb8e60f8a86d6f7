"""gmpi_tpu_torch.eval — see the package docstring."""
