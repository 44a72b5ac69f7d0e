"""The trainer's data pipeline (host numpy)."""
