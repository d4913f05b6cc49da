"""Engine templates of the port (the recommendation template's serving half so far)."""
