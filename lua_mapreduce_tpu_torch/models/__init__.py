"""Models of the port: the digits MLP, the LM (serving and single-device
training), and the conv family (LeNet-5, ResNet-18)."""
