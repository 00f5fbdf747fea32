"""Self-critical sequence training (SCST) pieces of the port."""
