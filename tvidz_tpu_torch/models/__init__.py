"""Composed models of the port (``FingerprintModel``)."""
