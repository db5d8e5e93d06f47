"""The ResNet-20 low-bit training loop (``python -m repro_torch.train``)."""
