"""obs: see the modules of this package."""
