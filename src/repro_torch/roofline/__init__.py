"""Roofline model of the port on the H100: constants, the step's counted cost, records."""
