"""Statistics and checkpoint helpers of the PyTorch port."""
