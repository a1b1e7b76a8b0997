"""Cohort data of the PyTorch port."""
