"""The benchmark harness of ``vfs_tpu_torch``: one general runner that
finds a cell's configuration, traffic, driver and per-layer metrics by the
names in ``BENCHMARK.json`` (``spec``), checks the card (``card``), traces
a window (``trace``), counts operations (``flops``), makes inputs and
weights from the seed (``traffic``, ``weights``) and prints the result
line (``runner``)."""
