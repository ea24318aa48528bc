"""Host-side data helpers of the port (numpy only)."""
