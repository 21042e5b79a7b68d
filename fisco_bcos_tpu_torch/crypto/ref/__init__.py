"""Pure-Python reference oracles (the port's own copies)."""
