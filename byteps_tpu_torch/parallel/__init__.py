"""Parallelism building blocks of the port (tp = 1 so far)."""
