"""The digits DP-SGD example, as six MapReduce functions."""
