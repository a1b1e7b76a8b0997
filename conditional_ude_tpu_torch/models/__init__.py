"""C-peptide model of the PyTorch port."""
