"""ops: see the modules of this package."""
