"""Weight carry into the port's modules."""
