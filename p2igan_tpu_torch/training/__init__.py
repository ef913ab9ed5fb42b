"""Checkpoint handling of the port."""
