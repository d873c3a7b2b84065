"""PNG export (numpy only)."""
