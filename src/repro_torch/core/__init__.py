"""The engine: eval step and loop on one device."""
