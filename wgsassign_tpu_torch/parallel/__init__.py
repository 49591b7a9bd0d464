"""Device runtime (single device)."""
