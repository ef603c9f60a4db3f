"""The benchmark of ``visfd_tpu_torch``: ``python3 portbench/run.py``."""
