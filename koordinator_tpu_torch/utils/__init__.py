"""utils: see the modules of this package."""
