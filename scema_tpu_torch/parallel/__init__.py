"""See the package docstring of scema_tpu_torch."""
