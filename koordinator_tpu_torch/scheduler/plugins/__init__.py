"""plugins: see the modules of this package."""
