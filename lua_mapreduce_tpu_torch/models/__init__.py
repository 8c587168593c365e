"""Models of the port (the digits MLP in this slice)."""
