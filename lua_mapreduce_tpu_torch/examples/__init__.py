"""Example programs of the port."""
