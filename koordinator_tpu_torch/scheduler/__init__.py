"""scheduler: see the modules of this package."""
