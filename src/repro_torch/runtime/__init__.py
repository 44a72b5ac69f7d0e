"""Fault tolerance: the fleet's sweeps (worker supervision, checkpoint /
resume) and the trainer's (stragglers, elastic restart)."""
