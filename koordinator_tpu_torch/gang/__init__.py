"""gang: see the modules of this package."""
