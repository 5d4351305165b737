"""Command-line entry points."""
from . import mesh, steps
