"""The layers the decode LM builder uses: ``data`` and ``create_parameter``."""

from .io import data
from .tensor import create_parameter

__all__ = ['data', 'create_parameter']
