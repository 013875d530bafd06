"""Example scripts of the port (counterparts of the root ``examples/``)."""
