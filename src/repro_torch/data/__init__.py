"""Dataset builders of the port (numpy only)."""
