"""Fault injection: disturbance lanes, their consumption, the board."""
