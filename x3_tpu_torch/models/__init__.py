"""Public encode/decode entry points of the port."""
