"""Parallel layers: the tp=1 forms this port runs on one card."""
