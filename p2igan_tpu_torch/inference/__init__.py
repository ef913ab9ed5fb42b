"""Sliding-window serving of the port."""
