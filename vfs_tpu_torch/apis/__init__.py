from .inference import inference_recognizer, init_recognizer
from .test import multi_process_test, single_process_test
from .train import (TrainState, apply_mixed_precision, build_val_eval_fn,
                    make_train_step, model_takes_labels, train_model)

__all__ = ['inference_recognizer', 'init_recognizer', 'multi_process_test',
           'single_process_test', 'TrainState', 'apply_mixed_precision',
           'build_val_eval_fn', 'make_train_step', 'model_takes_labels',
           'train_model']
