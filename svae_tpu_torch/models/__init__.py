"""Structured priors (LDS)."""
