"""quota: see the modules of this package."""
