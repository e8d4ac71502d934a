"""Training: AdamW with the reference's groups, the Trainer, the keypose
loss and metrics, the canonical ChainedDiffuser and Act3D constructions
with their Trainer functions, and the two training CLIs (``main_keypose``,
``main_trajectory``, sharing ``cli.run_training``)."""
