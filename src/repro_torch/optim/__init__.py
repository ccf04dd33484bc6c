"""Momentum SGD (paper Eq. 1) and learning-rate schedules."""
