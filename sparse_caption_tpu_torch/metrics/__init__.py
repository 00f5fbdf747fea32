"""Caption metrics of the port (what the SCST reward needs so far)."""
