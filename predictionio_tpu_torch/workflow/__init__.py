"""Deploy lifecycle of the port (the query server so far)."""
