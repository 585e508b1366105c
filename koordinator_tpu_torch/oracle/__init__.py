"""oracle: see the modules of this package."""
