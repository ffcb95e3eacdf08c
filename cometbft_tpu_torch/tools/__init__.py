"""Measurement scripts of the port that are not kernels of its path."""
