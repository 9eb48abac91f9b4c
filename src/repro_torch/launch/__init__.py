"""The trainer and its fault-tolerance hooks."""
