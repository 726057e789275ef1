"""Checkpoints and logging for the port's CLIs."""
