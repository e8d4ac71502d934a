"""Training: AdamW with the reference's groups, the Trainer, and the
canonical ChainedDiffuser construction and loss."""
