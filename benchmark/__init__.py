"""The benchmark of skeres_tpu_torch on an NVIDIA H100 (``run.py``)."""
