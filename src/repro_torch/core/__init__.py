"""Core of the PyTorch port (counterpart of ``repro.core``)."""
