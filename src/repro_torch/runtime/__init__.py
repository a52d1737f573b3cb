"""Runtime: the Program executor."""
from .executor import cached_runner, run

__all__ = ["run", "cached_runner"]
