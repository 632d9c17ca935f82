"""Benchmark of ``torchsnapshot_tpu_torch`` on one NVIDIA GPU; see ``run.py``."""
