"""Example scripts of the PyTorch port (twins of ``examples/``)."""
