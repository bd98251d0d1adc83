from .test import multi_process_test, single_process_test

__all__ = ['multi_process_test', 'single_process_test']
