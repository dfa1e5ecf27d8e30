"""The reference's benchmark stages on the port, driven through its own
entry points (``python -m repro_torch.bench.<stage>``)."""
