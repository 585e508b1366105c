"""apis: see the modules of this package."""
