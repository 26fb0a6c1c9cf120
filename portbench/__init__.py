"""The benchmark of ``akmc_tpu_torch`` on one NVIDIA H100 (``run.py``)."""
