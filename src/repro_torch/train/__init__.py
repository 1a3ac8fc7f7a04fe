"""LM training of the port: counterpart of ``repro.train``."""
