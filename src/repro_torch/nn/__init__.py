"""Neural-net primitives of the port."""
