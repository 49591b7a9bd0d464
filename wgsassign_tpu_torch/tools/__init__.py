"""Developer tools of the port (not used by the CLI)."""
