"""Flood protocols of the port."""
