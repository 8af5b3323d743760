"""Re-export of core.backward (reference: paddle_tpu backward.py;
python/paddle/fluid/backward.py)."""

from .core.backward import append_backward, grad_var_name  # noqa: F401
