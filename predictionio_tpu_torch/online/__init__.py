"""Online learning of the port: ALS fold-in."""
