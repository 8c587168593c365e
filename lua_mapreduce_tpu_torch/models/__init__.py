"""Models of the port: the digits MLP, the LM serving subset, and the
conv family (LeNet-5, ResNet-18)."""
