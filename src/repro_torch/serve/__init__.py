"""Serving: the request frontend, the CNN server, and the LM engines (slot
and paged) with their KV caches and steps."""
