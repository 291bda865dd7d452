"""Standalone tools of the port (run as ``python -m deepmod_tpu_torch.tools.<name>``)."""
