"""Batch containers, the host pyramid, the readers and the loader."""
