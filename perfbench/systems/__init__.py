"""Drivers of the kinds of deployment a configuration names by its ``system``."""
