"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), frozen here as the benchmark's yardstick."""

HBM_BYTES_PER_S = 3.35e12
