"""Synthetic data, FL partitioners and SSL augmentations of the port."""
