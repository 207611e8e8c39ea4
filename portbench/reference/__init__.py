"""Plain PyTorch references that decide ``correct``.

They import torch and numpy only: nothing of the program, of its JAX
reference or of the benchmark's drivers. They run in float32 with TF32
off and take nothing the program made except the outputs they judge.
"""

import contextlib

import torch


@contextlib.contextmanager
def exact_f32():
    """float32 products with TF32 off (cuBLAS and cuDNN)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
