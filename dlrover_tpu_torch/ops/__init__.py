"""Ops of the PyTorch port: hand-written Hopper kernels and plain torch."""
