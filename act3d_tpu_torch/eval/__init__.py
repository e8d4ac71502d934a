"""Closed-loop serving: the chained keypose -> trajectory Actioner."""
