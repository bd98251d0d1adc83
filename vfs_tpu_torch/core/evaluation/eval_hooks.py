"""Train-time evaluation hook (counterpart of
``vfs_tpu/core/evaluation/eval_hooks.py``; reference:
mmaction/core/evaluation/eval_hooks.py:12-197): an eval after every
``interval`` epochs, the best ``key_indicator`` tracked in ``best.json``,
the greater/less rule inferred from the key's name when not given."""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Optional

from ...utils import get_root_logger

GREATER_KEYS = ('acc', 'top', 'AR@', 'auc', 'precision', 'mAP', 'J&F',
                'J-Mean', 'F-Mean', 'PCK', 'mIoU', 'success')
LESS_KEYS = ('loss',)


class EvalHook:
    """Runs ``eval_fn() -> dict`` every ``interval`` epochs and tracks the
    best ``key_indicator``; ``save_best=False`` (the ranks other than 0
    of a run of several processes) tracks it without writing
    ``best.json``."""

    def __init__(self, eval_fn, interval: int = 1,
                 key_indicator: Optional[str] = None,
                 rule: Optional[str] = None, work_dir: str = '.',
                 save_best: bool = True):
        self.eval_fn = eval_fn
        self.save_best = save_best
        self.interval = interval
        self.key_indicator = key_indicator
        self.work_dir = work_dir
        if rule is None and key_indicator is not None:
            if any(k in key_indicator for k in GREATER_KEYS):
                rule = 'greater'
            elif any(k in key_indicator for k in LESS_KEYS):
                rule = 'less'
            else:
                raise ValueError(
                    f'cannot infer rule for {key_indicator}; set rule')
        if rule not in (None, 'greater', 'less'):
            raise ValueError(f"rule {rule!r}: 'greater' or 'less'")
        self.rule = rule
        self.best_score = None
        self.best_json = osp.join(work_dir, 'best.json')

    def _is_better(self, score: float) -> bool:
        if self.best_score is None:
            return True
        if self.rule == 'greater':
            return score > self.best_score
        return score < self.best_score

    def after_epoch(self, epoch: int) -> Optional[Dict[str, Any]]:
        if (epoch + 1) % self.interval != 0:
            return None
        results = self.eval_fn()
        logger = get_root_logger()
        logger.info('Eval results: ' + ', '.join(
            f'{k}={v:.4f}' for k, v in results.items()
            if isinstance(v, (int, float))))
        if self.key_indicator is not None and self.key_indicator in results:
            score = float(results[self.key_indicator])
            if self._is_better(score):
                self.best_score = score
                if not self.save_best:
                    return results
                os.makedirs(self.work_dir, exist_ok=True)
                with open(self.best_json, 'w') as f:
                    json.dump(dict(best_score=score, best_epoch=epoch + 1,
                                   key_indicator=self.key_indicator), f)
                logger.info(f'New best {self.key_indicator}: {score:.4f}')
        return results
