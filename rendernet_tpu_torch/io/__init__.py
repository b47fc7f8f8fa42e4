"""Host-side file formats (numpy only)."""
