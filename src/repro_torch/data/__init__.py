"""Data of the PyTorch port (counterpart of ``repro.data``)."""
