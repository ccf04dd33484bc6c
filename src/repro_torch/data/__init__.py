"""Numpy-only dataset generators and the paper's dataset registry."""
