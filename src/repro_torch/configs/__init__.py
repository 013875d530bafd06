"""Configs of the PyTorch port (counterpart of ``repro.configs``)."""
