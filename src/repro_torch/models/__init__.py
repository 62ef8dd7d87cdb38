"""Model definitions of the PyTorch port (config, layers, model, convert)."""
