"""state: see the modules of this package."""
