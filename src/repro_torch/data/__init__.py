"""Step-indexed data sources of the PyTorch port (numpy batches)."""
