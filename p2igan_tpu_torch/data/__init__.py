"""Host data layer of the port (numpy; no jax)."""
