"""control: see the modules of this package."""
