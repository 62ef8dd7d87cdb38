"""Step-atomic, content-verified checkpoints of the PyTorch port."""
