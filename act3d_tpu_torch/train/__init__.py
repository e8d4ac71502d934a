"""Training: AdamW with the reference's groups, the Trainer, the keypose
loss and metrics, and the canonical ChainedDiffuser and Act3D
constructions with their Trainer functions."""
