"""Small shared helpers of the PyTorch port."""
