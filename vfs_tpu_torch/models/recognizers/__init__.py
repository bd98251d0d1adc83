from .recognizers import BaseRecognizer, Recognizer2D, Recognizer3D

__all__ = ['BaseRecognizer', 'Recognizer2D', 'Recognizer3D']
