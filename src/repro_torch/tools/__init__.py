"""The port's smoke tools (``tools/*_smoke.py``): each a ``python -m``
entry point that exits 0 when its claims hold."""
