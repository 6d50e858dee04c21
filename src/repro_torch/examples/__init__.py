"""Walkthroughs of the port, run as modules (``python -m repro_torch.examples.<name>``)."""
