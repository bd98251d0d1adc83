from .test import multi_process_test, single_process_test
from .train import (TrainState, apply_mixed_precision, build_val_eval_fn,
                    make_train_step, train_model)

__all__ = ['multi_process_test', 'single_process_test', 'TrainState',
           'apply_mixed_precision', 'build_val_eval_fn', 'make_train_step',
           'train_model']
