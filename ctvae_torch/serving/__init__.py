"""Serving entry points of the port (``inference.py``)."""
