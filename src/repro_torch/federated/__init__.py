"""federated of the PyTorch port."""
