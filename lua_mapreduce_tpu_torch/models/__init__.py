"""Models of the port: the digits MLP and the LM serving subset."""
