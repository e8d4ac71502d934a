"""Network building blocks: attention layers, CLIP trunk, FPN, encoder."""
