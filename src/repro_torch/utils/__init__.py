"""Host utilities of the port (copies of ``repro/utils``)."""
