"""Serving surface of the PyTorch port."""
