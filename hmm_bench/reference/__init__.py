"""The plain reference of one HMM macro-step (FE, job selection, MD,
bridging) that decides ``correct``; it imports nothing of the port."""
