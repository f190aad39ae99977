"""Models of the port: the paper's Table III CNN (``cnn``)."""
