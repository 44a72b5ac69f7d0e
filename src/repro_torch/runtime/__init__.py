"""Fault tolerance: the fleet's sweeps (worker supervision, checkpoint /
resume) and the trainer's (stragglers, elastic restart); and the spans the
manager marks its epoch with under a profiler (``spans``)."""
