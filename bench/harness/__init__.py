"""The benchmark of the PyTorch port: spec, traffic, x^0, the plain
reference, the comparison, the trace reduction and the frozen counts."""
