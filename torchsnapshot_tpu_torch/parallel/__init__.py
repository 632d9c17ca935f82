"""Sequence-parallel operators of the PyTorch port."""
