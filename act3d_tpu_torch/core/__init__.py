"""Configuration of the port's training CLIs."""
