"""The benchmark's tests (CPU, and marked ``card`` for the chip)."""
