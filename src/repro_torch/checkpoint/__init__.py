"""The trainer's checkpointer."""
