"""The LM trainer script of the port."""
