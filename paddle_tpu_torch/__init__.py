"""paddle_tpu_torch: the paddle_tpu framework ported to PyTorch and CUDA
for an NVIDIA H100.

Module paths mirror ``paddle_tpu`` so each piece has an obvious
counterpart; the TPU's Pallas kernels become hand-written CUDA kernels in
``csrc/`` (bound in ``ops/kernels/``), each beside its plain PyTorch
version. This package imports torch and never jax or paddle_tpu.

Entry points (Executor, Trainer, DecodeEngine) run on ``CUDAPlace(0)``
unless the caller passes a place; ``CPUPlace()`` runs everything on the
host with the plain versions. Files written by ``io`` (persistables,
checkpoints, inference models) use the JAX package's format.
"""

from . import (backward, clip, dataset, fault, initializer, io, layers,
               learning_rate_decay, nets, optimizer, reader, regularizer,
               trainer)
from .core.backward import append_backward
from .core.errors import EnforceError, enforce
from .core.executor import Executor
from .core.flags import init_flags
from .core.lod import create_lod_tensor, pad_sequences
from .core.place import CPUPlace, CUDAPlace
from .core.program import (Program, default_main_program,
                           default_startup_program, program_guard,
                           reset_default_programs, switch_main_program,
                           switch_startup_program)
from .core.scope import Scope, global_scope, scope_guard
from .data_feeder import DataFeeder
from .fault import CheckpointConfig
from .memory_optimize import memory_optimize
from .param_attr import ParamAttr, WeightNormParamAttr
from .trainer import (BeginEpochEvent, BeginStepEvent, EndEpochEvent,
                      EndStepEvent, Trainer)

__all__ = ['backward', 'clip', 'dataset', 'fault', 'initializer', 'io',
           'layers', 'learning_rate_decay', 'nets', 'optimizer', 'reader',
           'regularizer', 'trainer', 'append_backward', 'EnforceError',
           'enforce', 'init_flags', 'create_lod_tensor', 'pad_sequences',
           'Executor', 'CPUPlace', 'CUDAPlace', 'Program',
           'default_main_program', 'default_startup_program',
           'program_guard', 'reset_default_programs', 'switch_main_program',
           'switch_startup_program', 'Scope',
           'global_scope', 'scope_guard', 'DataFeeder', 'CheckpointConfig',
           'ParamAttr', 'WeightNormParamAttr', 'memory_optimize', 'Trainer',
           'BeginEpochEvent', 'EndEpochEvent', 'BeginStepEvent',
           'EndStepEvent']
