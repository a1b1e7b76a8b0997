"""Likelihood profiles and identifiability of the PyTorch port."""
