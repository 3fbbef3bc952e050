"""Utilities of the port: the JSONL logger."""
