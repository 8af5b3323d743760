"""Native (C++) runtime pieces, bound through ctypes (reference: paddle_tpu
native/__init__.py; paddle/fluid/pybind and the C++ data pipeline).

The port keeps its own copy of the host staging ring (staging.cpp, plain C
ABI). It is compiled with g++ at first use into ``paddle_tpu_torch/_build/``
(listed in .gitignore), keyed by a hash of the source and flags, so a later
process in the same checkout reuses it. Nothing builds at import time.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')
GXX_FLAGS = ('-O2', '-shared', '-fPIC', '-std=c++17', '-pthread')
_LOCK = threading.Lock()
_STAGING = None


def build_native(name):
    """Compile native/<name>.cpp into _build/lib<name>-<digest>.so unless
    that build exists; returns its path. A per-process temporary name and
    an atomic rename: concurrent builders (pytest-xdist workers) each make
    a whole library and a half-written file is never seen under the
    final name."""
    src = os.path.join(_HERE, name + '.cpp')
    h = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    with open(src, 'rb') as f:
        h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, 'lib%s-%s.so' % (name, h.hexdigest()[:12]))
    if os.path.exists(out):
        return out
    tmp = '%s.%d.tmp' % (out, os.getpid())
    proc = subprocess.run(['g++'] + list(GXX_FLAGS) + [src, '-o', tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('g++ failed to build %s (rc %d):\n%s'
                           % (src, proc.returncode, proc.stderr))
    os.replace(tmp, out)
    return out


def load_staging():
    """Compile (if needed) and load the host staging ring (staging.cpp);
    thread-safe."""
    global _STAGING
    with _LOCK:
        if _STAGING is not None:
            return _STAGING
        lib = ctypes.CDLL(build_native('staging'))
        lib.staging_open.restype = ctypes.c_void_p
        lib.staging_open.argtypes = [ctypes.c_uint64, ctypes.c_int]
        lib.staging_capacity.restype = ctypes.c_uint64
        lib.staging_capacity.argtypes = [ctypes.c_void_p]
        lib.staging_acquire_fill.restype = ctypes.c_void_p
        lib.staging_acquire_fill.argtypes = [ctypes.c_void_p]
        lib.staging_commit.restype = ctypes.c_int
        lib.staging_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.staging_acquire_read.restype = ctypes.c_void_p
        lib.staging_acquire_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.staging_release.restype = ctypes.c_int
        lib.staging_release.argtypes = [ctypes.c_void_p]
        lib.staging_close_ring.argtypes = [ctypes.c_void_p]
        lib.staging_free.argtypes = [ctypes.c_void_p]
        _STAGING = lib
        return lib
