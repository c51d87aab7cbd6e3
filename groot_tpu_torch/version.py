"""Version info (counterpart of groot_tpu/version.py).

Mirrors src/version/version.go:15-22: GetVersion returns the
full semver; GetBaseVersion (major.minor) selects the database download dir.
"""

__version__ = "1.1.2"


def get_version() -> str:
    return __version__


def get_base_version() -> str:
    return ".".join(__version__.split(".")[:2])
