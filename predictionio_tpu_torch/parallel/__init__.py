"""Factor models of the port (training comes with a later slice)."""
