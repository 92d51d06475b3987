"""Neighbour ops and the kernel wrappers."""
