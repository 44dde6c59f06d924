"""Runnable demos of the port (``python -m icp_tpu_torch.demos.<name>``)."""
