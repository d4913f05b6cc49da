"""Event data of the port: the event record and the columnar training read."""
