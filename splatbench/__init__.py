"""The benchmark of ``gsplat_tpu_torch`` on one NVIDIA H100: the harness,
its plain reference and its yardstick (see ``harness.py``)."""
