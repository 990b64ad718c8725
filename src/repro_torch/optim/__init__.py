"""The optimizer (``adamw``) and gradient compression (``compression``)."""
