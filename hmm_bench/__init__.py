"""The benchmark of ``scema_tpu_torch``: seconds per HMM macro-step of the
dogbone on one NVIDIA GPU.  See README.md."""
