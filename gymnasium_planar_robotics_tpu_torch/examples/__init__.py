"""The port's example scripts, counterparts of the repository's ``examples/``."""
