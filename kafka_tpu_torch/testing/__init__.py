"""Synthetic problems and sinks for tests and smoke runs of the port."""
