"""Losses and frozen-network fits of the PyTorch port."""
