"""Host-side utilities (plots)."""
