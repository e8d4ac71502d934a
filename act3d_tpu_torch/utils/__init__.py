"""Helpers shared by tests and smoke runs."""
