"""Plain tensor functions of the serving path (rotations, rotary codes,
DDPM schedules, ghost-point sampling, context selection, attention)."""
