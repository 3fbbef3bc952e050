"""Replay buffers."""
