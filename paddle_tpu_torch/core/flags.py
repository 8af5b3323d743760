"""Global flags (reference: paddle_tpu core/flags.py; the gflags of
python/paddle/fluid/__init__.py's __bootstrap__).

Values are read from the environment (PADDLE_TPU_<NAME>) at first access,
overridable with init_flags / set_flag.
"""

import os

__all__ = ['init_flags', 'set_flag', 'get_flag', 'FLAGS']

_DEFAULTS = {
    # executor
    'benchmark': False,            # sync + time every executor step
    'use_bf16': False,             # default Program.amp for new programs
    # kept for scripts that set it; nothing in the port reads it: a CUDA
    # graph cannot be saved across processes (ROADMAP Queue 1 item 8)
    'compile_cache': 'auto',
    # data pipeline
    'reader_prefetch': 256,
    # logging
    'v': 0,                        # verbosity (GLOG_v analog)
}

FLAGS = {}


def _coerce(default, raw):
    if isinstance(default, bool):
        return raw.lower() in ('1', 'true', 'yes', 'on')
    return type(default)(raw)


def init_flags(overrides=None):
    """(Re)load flags from defaults + environment + overrides."""
    FLAGS.clear()
    for name, default in _DEFAULTS.items():
        env = os.environ.get('PADDLE_TPU_' + name.upper())
        FLAGS[name] = _coerce(default, env) if env is not None else default
    for name, value in (overrides or {}).items():
        set_flag(name, value)
    return dict(FLAGS)


def set_flag(name, value):
    if name not in _DEFAULTS:
        raise KeyError('unknown flag %r (known: %s)'
                       % (name, sorted(_DEFAULTS)))
    if not FLAGS:
        init_flags()
    FLAGS[name] = value


def get_flag(name):
    if not FLAGS:
        init_flags()
    return FLAGS[name]
