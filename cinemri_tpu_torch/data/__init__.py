"""Host-side data helpers (numpy only)."""
