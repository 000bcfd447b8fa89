"""layers of the PyTorch port."""
