"""Serving engine of the port: counterpart of ``repro.serve``."""
