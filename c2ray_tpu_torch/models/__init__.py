"""Physical models of the port that run on the host (numpy)."""
