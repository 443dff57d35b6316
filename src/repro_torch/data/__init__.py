"""Host data (numpy) and its on-device finish (torch)."""
