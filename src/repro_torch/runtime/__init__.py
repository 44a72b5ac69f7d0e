"""Fault tolerance of the fleet's scenario sweeps: worker supervision and
checkpoint / resume."""
