"""Schedules, diffusion steps and the acting orchestrator."""
