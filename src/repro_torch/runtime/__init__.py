"""The training runtime of the PyTorch port."""
