from .inference import inference_recognizer, init_recognizer
from .test import multi_process_test, single_process_test
from .train import (TrainState, apply_mixed_precision, build_val_eval_fn,
                    make_train_step, model_takes_labels, train_model)
from .train_localizer import (LOCALIZER_TYPES, make_localizer_eval_step,
                              make_localizer_train_step, prepare_batch,
                              train_localizer_model)

__all__ = ['inference_recognizer', 'init_recognizer', 'LOCALIZER_TYPES',
           'make_localizer_eval_step', 'make_localizer_train_step',
           'multi_process_test', 'prepare_batch', 'single_process_test',
           'TrainState', 'apply_mixed_precision', 'build_val_eval_fn',
           'make_train_step', 'model_takes_labels', 'train_localizer_model',
           'train_model']
