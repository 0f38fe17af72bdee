"""singa_tpu_torch.tools — command-line tools of the port, shaped like
the JAX package's ``tools/`` (run as ``python -m
singa_tpu_torch.tools.<name>``)."""
