"""The port's examples (``examples/``): each a ``python -m`` entry point."""
