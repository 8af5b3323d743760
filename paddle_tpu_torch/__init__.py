"""paddle_tpu_torch: the paddle_tpu framework ported to PyTorch and CUDA
for an NVIDIA H100.

Module paths mirror ``paddle_tpu`` so each piece has an obvious
counterpart; the TPU's Pallas kernels become hand-written CUDA kernels in
``csrc/`` (bound in ``ops/kernels/``), each beside its plain PyTorch
version. This package imports torch and never jax or paddle_tpu.

Entry points run on ``CUDAPlace(0)`` unless the caller passes a place;
``CPUPlace()`` runs everything on the host with the plain versions.
"""

from . import initializer, layers, optimizer
from .core.executor import Executor
from .core.place import CPUPlace, CUDAPlace
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard,
                           reset_default_programs)
from .core.scope import Scope, global_scope, scope_guard
from .memory_optimize import memory_optimize
from .param_attr import ParamAttr

__all__ = ['initializer', 'layers', 'optimizer', 'Executor', 'CPUPlace',
           'CUDAPlace', 'Program', 'default_main_program',
           'default_startup_program', 'program_guard',
           'reset_default_programs', 'Scope', 'global_scope', 'scope_guard',
           'ParamAttr', 'memory_optimize']
