"""QoS plane of the port (so far only the degradation ladder's rungs)."""
