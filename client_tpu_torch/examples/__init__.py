"""Runnable clients of the port, its counterparts of the reference's
``examples/``: ``python -m client_tpu_torch.examples.<name> -u <url>``."""
