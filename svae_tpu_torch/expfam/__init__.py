"""Exponential families of the LDS prior (NIW, MNIW)."""
