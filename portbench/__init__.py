"""The benchmark of ``vfs_tpu_torch`` on the card (``run.py``)."""
