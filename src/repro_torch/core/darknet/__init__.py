"""Darknet front end: cfg parser, layer library, network builder."""
