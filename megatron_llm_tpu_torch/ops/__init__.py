"""Kernels and the plain tensor ops around them."""
