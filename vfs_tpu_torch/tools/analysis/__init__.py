"""Analysis CLIs of vfs_tpu_torch (counterparts of ``tools/analysis``),
each run as ``python -m vfs_tpu_torch.tools.analysis.<name>`` and each on
the CUDA card unless ``--device cpu`` (``bench_processing`` is host-only).

- ``bench_kernel``: the propagation variants' ms/frame and argmax
  agreement against the exact fp32 scan (layout-only variants as aliases).
- ``profile_kernel``: a ``torch.profiler`` trace of ``propagate_video``.
- ``bench_extract``: ``VanillaTracker._extract_feats`` ms/frame, FLOPs
  and MFU over ``batch_step`` and backbone dtype.
- ``benchmark``: the eval CLI's dataset loop in frames per second.
- ``get_flops``: a backbone's parameters and FLOPs.
- ``bench_processing``: the host data pipeline's samples per second.
- ``bench_pretrain``: pretraining's loader, device and end-to-end rates.
- ``bench_track``: SiamFC's five tracking modes, fps and box agreement.
- ``analyze_logs``: ``cal_train_time`` and ``plot_curve`` over the
  training JSONL.
- ``report_accuracy``: top-1, top-5 and mean class accuracy of a weighted
  fusion of recognition score files (host-only).
"""
