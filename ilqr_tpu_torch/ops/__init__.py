"""Compute kernels and small-matrix linear algebra of the port."""
