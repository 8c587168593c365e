"""Iterative ALS matrix factorization as six MapReduce functions."""
