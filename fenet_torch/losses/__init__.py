"""See the package docstring of fenet_torch."""
