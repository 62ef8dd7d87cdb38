"""AdamW of the PyTorch port."""
