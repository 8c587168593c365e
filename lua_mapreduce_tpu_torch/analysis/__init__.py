"""Static analysis of user task modules: the lowerability oracle the
compiled engines consult (``contracts``), with the ``Finding`` record
(``lint``) and the AST helper (``rules``) it needs — trimmed copies of
the JAX package's ``analysis/`` modules."""
