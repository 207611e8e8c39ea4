"""Matrix primitives of the port."""
