"""Checkpoints: atomic npz + JSON manifest, keyed by flat parameter names."""
