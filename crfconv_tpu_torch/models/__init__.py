"""Model modules."""
