"""External sort (the push shuffle's workload)."""
