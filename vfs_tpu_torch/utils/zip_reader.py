"""Zip-bundle IO backend (counterpart of ``vfs_tpu/utils/zip_reader.py``;
reference: mmaction/utils/zip_reader.py:7-130): reads frames from
per-video zip bundles without extracting them, for datasets whose one
file a frame strains the filesystem. Host code."""

from __future__ import annotations

import io
import os.path as osp
import zipfile
from typing import Dict


class ZipReader:
    """Process-wide cache of open zip handles."""

    zip_bank: Dict[str, zipfile.ZipFile] = {}

    @classmethod
    def get_zipfile(cls, path: str) -> zipfile.ZipFile:
        if path not in cls.zip_bank:
            cls.zip_bank[path] = zipfile.ZipFile(path, 'r')
        return cls.zip_bank[path]

    @classmethod
    def split_zip_style_path(cls, path: str):
        """'a/b.zip@c/d.jpg' -> ('a/b.zip', 'c/d.jpg'); also supports the
        implicit style where the first existing .zip prefix wins."""
        if '@' in path:
            zip_path, rel = path.split('@', 1)
            return zip_path, rel.lstrip('/')
        parts = path.split('/')
        for i in range(len(parts), 0, -1):
            cand = '/'.join(parts[:i])
            if cand.endswith('.zip') and osp.isfile(cand):
                return cand, '/'.join(parts[i:])
        raise FileNotFoundError(f'no zip bundle found in path {path}')

    @classmethod
    def read(cls, path: str) -> bytes:
        zip_path, rel = cls.split_zip_style_path(path)
        zf = cls.get_zipfile(zip_path)
        return zf.read(rel)

    @classmethod
    def imread(cls, path: str, flag: str = 'color'):
        import cv2
        import numpy as np
        data = np.frombuffer(cls.read(path), np.uint8)
        code = cv2.IMREAD_COLOR if flag == 'color' else cv2.IMREAD_UNCHANGED
        img = cv2.imdecode(data, code)
        if flag == 'color':
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        return img

    @classmethod
    def close(cls):
        for zf in cls.zip_bank.values():
            zf.close()
        cls.zip_bank.clear()
