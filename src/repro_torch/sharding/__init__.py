"""Sharding hints: the logical axis tags model code names and the mesh the
sharded backend distributes over."""
