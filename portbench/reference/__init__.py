"""Plain PyTorch references of the benchmark's configurations. They
import nothing of the program (``vfs_tpu_torch``) nor of the JAX package,
and compute in fp32 with TF32 off unless a control asks otherwise
(``precision``)."""
