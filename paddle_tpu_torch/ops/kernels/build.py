"""Builds and loads the port's CUDA kernels.

All sources under ``paddle_tpu_torch/csrc/`` compile with ONE ``nvcc`` call
into one shared library with a plain C interface, loaded with ctypes. The
build runs at first use, into ``paddle_tpu_torch/_build/`` (listed in
.gitignore), and is keyed by a hash of the sources and flags, so a later
process in the same checkout reuses it. Nothing here runs at import time:
the CPU tests import every module of the port on a machine without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
SOURCES = ('layer_norm.cu', 'paged_attention.cu', 'flash_attention.cu',
           'batch_norm.cu')
HEADERS = ('common.cuh', 'flash_tiles.cuh')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


class BuildResult(object):
    """What one build produced: the library path, the seconds nvcc took
    (0.0 when an existing build was reused) and nvcc's output, which
    holds ptxas's registers / shared memory / spills per kernel."""

    def __init__(self, path, seconds, log):
        self.path = path
        self.seconds = seconds
        self.log = log


_lock = threading.Lock()
_loaded = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    raise RuntimeError('nvcc not found (looked on PATH and in %s); the '
                       'CUDA kernels cannot be built' % home)


def _digest():
    h = hashlib.sha1(' '.join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), 'rb') as f:
            h.update(name.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels unless this exact build exists. Returns a
    BuildResult; raises RuntimeError with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, 'libpaddle_tpu_torch_%s.so' % _digest())
    log_path = lib + '.log'
    if os.path.exists(lib):
        log = ''
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildResult(lib, 0.0, log)
    tmp = '%s.%d.tmp' % (lib, os.getpid())
    cmd = [_nvcc()] + list(NVCC_FLAGS) + ['-o', tmp] + \
        [os.path.join(CSRC, s) for s in SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed (rc %d): %s\n%s'
                           % (proc.returncode, ' '.join(cmd), log))
    with open(log_path, 'w') as f:
        f.write(log)
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


def library():
    """The loaded kernel library (built on first call), with argtypes set."""
    with _lock:
        lib = _loaded.get('lib')
        if lib is None:
            lib = ctypes.CDLL(build().path)
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ptt_layer_norm.argtypes = [p, p, p, p, i, i, f, i, p]
            lib.ptt_layer_norm.restype = i
            lib.ptt_paged_attention.argtypes = [
                p, p, p, p, ctypes.c_longlong, p, p, p,
                i, i, i, i, i, i, i, i, f, i, p]
            lib.ptt_paged_attention.restype = i
            dims = [i, i, i, i, i, i, f, i, p]   # b h tq tk d causal scale
            # ... dtype, then the launched kernel's code (out), then stream
            lib.ptt_flash_fwd.argtypes = (
                [p] * 7 + dims[:-1] + [ctypes.POINTER(i), p])
            lib.ptt_flash_fwd.restype = i
            lib.ptt_flash_bwd_dkv.argtypes = (
                [p] * 10 + dims[:-1] + [ctypes.POINTER(i), p])
            lib.ptt_flash_bwd_dkv.restype = i
            lib.ptt_flash_bwd_dq.argtypes = (
                [p] * 10 + dims[:-1] + [ctypes.POINTER(i), p])
            lib.ptt_flash_bwd_dq.restype = i
            lib.ptt_flash_smem_bytes.argtypes = [i, i]
            lib.ptt_flash_smem_bytes.restype = i
            ll = ctypes.c_longlong
            lib.ptt_batch_norm_workspace.argtypes = [p, p, ll, i, ll, i, i,
                                                     p]
            lib.ptt_batch_norm_workspace.restype = ll
            lib.ptt_batch_norm_train.argtypes = [p] * 7 + [ll, ll, i, ll, i,
                                                           f, i, p]
            lib.ptt_batch_norm_train.restype = i
            _loaded['lib'] = lib
        return lib


def check(rc, what):
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (what, rc))


def dtype_code(dtype):
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError('kernel takes float32 or bfloat16, got %s' % dtype)
    return codes[dtype]
