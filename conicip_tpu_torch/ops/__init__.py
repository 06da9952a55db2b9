"""Dense linear-algebra kernels of the PyTorch port."""
