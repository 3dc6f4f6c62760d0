"""Positive-definite helpers, small-matrix solves, nested-tuple algebra."""
