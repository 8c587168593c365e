"""Iterative k-means as six MapReduce functions."""
