"""Optim of the PyTorch port (counterpart of ``repro.optim``)."""
