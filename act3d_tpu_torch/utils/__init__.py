"""Helpers shared by tests and smoke runs, and the CLIs' instruction and
workspace-bound loaders (``registry``)."""
