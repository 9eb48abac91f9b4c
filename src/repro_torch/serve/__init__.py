"""Serving: the request frontend over compiled networks."""
