"""Recognition and decoder networks."""
