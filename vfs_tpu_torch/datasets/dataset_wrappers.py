"""Dataset wrappers (counterpart of ``vfs_tpu/datasets/dataset_wrappers.py``;
reference: mmaction/datasets/dataset_wrappers.py)."""

from .registry import DATASETS


@DATASETS.register_module()
class RepeatDataset:
    """An epoch of ``times`` passes over ``dataset`` (reference :5-30; the
    r18 config uses times=2, r50 times=5)."""

    def __init__(self, dataset, times):
        from .builder import build_dataset
        if isinstance(dataset, dict):
            dataset = build_dataset(dataset)
        self.dataset = dataset
        self.times = times
        self._ori_len = len(dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len
