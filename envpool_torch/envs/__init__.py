"""Environment families of the port, each batched PyTorch functions."""
