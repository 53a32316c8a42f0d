"""Text data file input (the JAX package's ``io`` package)."""

from .parser import load_data_file

__all__ = ["load_data_file"]
