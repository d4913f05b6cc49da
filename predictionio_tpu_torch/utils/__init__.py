"""Device resolution shared by the port's entry points."""
