"""L5 HTTP services for the data layer (Event Server)."""
