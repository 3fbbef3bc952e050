"""Host-side agents."""
