"""Score network, policy and their building blocks."""
