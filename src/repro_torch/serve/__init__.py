"""Serving layer of the port."""
