"""Command-line scripts of the port: the synthetic scene generator and the
at-scale training run (``python -m gsplat_tpu_torch.scripts.<name>``)."""
