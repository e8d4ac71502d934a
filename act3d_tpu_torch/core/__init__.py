"""Configuration of the port's training CLIs, and the reader of flax's
``.msgpack`` checkpoints."""
