"""Plain models that decide ``correct``; they import torch only."""
