"""Model save/load (reference: paddle_tpu io.py; python/paddle/fluid/io.py).

The on-disk format is the JAX package's, so files cross between the two
packages in both directions:

- persistables: ``params.npz`` (one array a var; bfloat16 stored as its
  uint16 view) beside ``manifest.json`` ({name: {dtype, shape}});
- checkpoints: the same two files plus ``checkpoint.json``, written last,
  holding the step, the reader position, the trainer's state, the
  writing topology (``format_version`` 2, ``mesh`` {dp, pp, sp, tp, ep},
  ``hosts``) and the sha1 of both files, so a torn pair is refused;
- inference models: ``__model__.json`` (the pruned test Program in
  core/serialize.py's JSON, the feed and fetch names) beside the
  persistables.

Restores write into the scope's own tensors (``copy_``) wherever the
shape, dtype and device match, so a live executor's captured graphs
stay valid and replay (core/executor.py checks each scope tensor's
address). A snapshot copies every tensor to the host before it returns:
a replay updates parameters and moments in place, so only the disk
write may run on another thread.

The port runs one process on one device. A checkpoint recorded on
another topology (another mesh, several hosts) raises
NotImplementedError: resharding waits for the parallel modules.
"""

import hashlib
import json
import os
import tempfile
import threading
import warnings

import numpy as np
import torch

from .core.dtypes import to_torch_dtype
from .core.program import Parameter, default_main_program
from .core.scope import global_scope

__all__ = ['save_vars', 'save_params', 'save_persistables', 'load_vars',
           'load_params', 'load_persistables', 'save_inference_model',
           'load_inference_model', 'get_inference_program',
           'save_checkpoint', 'load_checkpoint', 'verify_checkpoint',
           'checkpoint_topology', 'current_topology', 'topology_changed',
           'topology_str', 'CHECKPOINT_FORMAT_VERSION', 'AsyncSaveHandle']

_PARAMS_FILE = 'params.npz'
_MANIFEST_FILE = 'manifest.json'

# 2: checkpoint.json records format_version / mesh / hosts (absent: the
# JAX package's pre-elastic layout, valid only on the topology that
# wrote it)
CHECKPOINT_FORMAT_VERSION = 2

# the mesh axes a checkpoint records, each 1 on the port's one device
MESH_AXES = ('dp', 'pp', 'sp', 'tp', 'ep')

_RESHARD_TODO = ('resharding a checkpoint onto another topology (and '
                 'multihost checkpoints) is not ported to '
                 'paddle_tpu_torch: it comes with the parallel modules '
                 '(ROADMAP Queue 1 item 9)')


def _is_parameter(var):
    return isinstance(var, Parameter)


def _is_persistable(var):
    return bool(getattr(var, 'persistable', False)) and not var.is_data


# The dtypes numpy lacks, kept as their raw bits under the JAX package's
# names: name -> (torch dtype, torch integer view, numpy integer view), the
# views of the same item size. Files, handoff packets and the engine's page
# copies all read this one table.
_RAW_BITS = {
    'bfloat16': (torch.bfloat16, torch.int16, np.uint16),
    'float8_e4m3fn': (torch.float8_e4m3fn, torch.uint8, np.uint8),
}
_RAW_BY_TORCH = {tdt: (name, view, npview)
                 for name, (tdt, view, npview) in _RAW_BITS.items()}


def raw_bits(t):
    """``t`` viewed as integers of its item size when numpy lacks its
    dtype, else ``t`` itself: a copy of these bits is exact."""
    raw = _RAW_BY_TORCH.get(t.dtype)
    return t if raw is None else t.view(raw[1])


def stored_numpy_dtype(dtype_name):
    """The numpy dtype a value stored under ``dtype_name`` is read as (the
    raw view for the dtypes numpy lacks); TypeError for an unknown name."""
    raw = _RAW_BITS.get(dtype_name)
    return np.dtype(raw[2] if raw else dtype_name)


def _to_numpy(value):
    """(host array, dtype name) of a scope value, always a copy; the dtypes
    numpy lacks as their raw bits under the JAX package's name (bfloat16
    as uint16, float8_e4m3fn as uint8)."""
    if not isinstance(value, torch.Tensor):
        arr = np.array(value)
        return arr, arr.dtype.name
    t = value.detach()
    t = t.clone() if t.device.type == 'cpu' else t.cpu()
    raw = _RAW_BY_TORCH.get(t.dtype)
    if raw is not None:
        name, view, npview = raw
        return t.view(view).numpy().view(npview), name
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_numpy(arr, dtype_name):
    """A CPU tensor of the array's stored dtype; bfloat16 and
    float8_e4m3fn from their raw bits (any array of their item size: the
    JAX package's npz holds float8 as a one-byte void type)."""
    arr = np.ascontiguousarray(arr)
    raw = _RAW_BITS.get(dtype_name)
    if raw is None:
        return torch.from_numpy(arr)
    tdt = raw[0]
    return torch.from_numpy(arr.view('<i%d' % tdt.itemsize)).view(tdt)


def _restore_into(scope, name, value, device, dtype=None):
    """Write a restored CPU tensor into the scope: into the tensor the
    scope holds (``copy_``) when its shape, dtype and device match —
    its address, which a captured graph checks, stays — else set anew on
    ``device``. ``dtype``: the var's declared dtype, which a value stored
    in another one (the JAX package keeps int64 counters as int32) is
    converted to."""
    if dtype is not None and value.dtype != dtype:
        value = value.to(dtype)
    cur = scope.find(name)
    if isinstance(cur, torch.Tensor) and cur.shape == value.shape and \
            cur.dtype == value.dtype and cur.device == device:
        with torch.no_grad():
            cur.copy_(value)
        return
    scope.var(name)
    scope.set(name, value.to(device))


# ------------------------------------------------------------- topology
def spec_to_json(spec):
    """A sharding spec (a sequence of axis names, None or tuples of names
    a dim) as a JSON list, the JAX package's wire form (its checkpoint
    manifests and KV-handoff headers). The port shards nothing."""
    if spec is None:
        return []
    return [list(e) if isinstance(e, (tuple, list)) else e for e in spec]


def checkpoint_topology(meta):
    """(hosts, {axis: size}) recorded in a checkpoint meta dict, or None
    for a pre-elastic checkpoint (format_version absent)."""
    if not meta or not meta.get('format_version'):
        return None
    sizes = {str(k): int(v) for k, v in (meta.get('mesh') or {}).items()}
    return int(meta.get('hosts', 1)), sizes


def current_topology(main_program=None):
    """(hosts, {axis: size}) the port restores on: one process, every
    mesh axis 1."""
    return 1, {a: 1 for a in MESH_AXES}


def topology_str(hosts, sizes):
    """Compact human form: 'hosts=2 dp4xtp2', or 'single' when trivial."""
    axes = 'x'.join('%s%d' % (a, s) for a, s in sorted(sizes.items())
                    if int(s) > 1)
    if hosts <= 1 and not axes:
        return 'single'
    return ('hosts=%d %s' % (hosts, axes or 'unsharded')).strip()


def topology_changed(meta, main_program=None):
    """True when the topology recorded in ``meta`` differs from the one
    the port restores on."""
    hosts, sizes = current_topology(main_program)
    rec = checkpoint_topology(meta)
    if rec is None:
        return hosts > 1 or any(int(v) > 1 for v in sizes.values())
    rhosts, rsizes = rec
    axes = set(sizes) | set(rsizes)
    return rhosts != hosts or any(
        int(sizes.get(a, 1)) != int(rsizes.get(a, 1)) for a in axes)


# ------------------------------------------------------------ snapshots
def _snapshot_vars(main_program, vars=None, predicate=None):
    """Device-to-host copy of the requested vars: the synchronous half of
    a save, done before the next step can update them in place."""
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    arrays, manifest = {}, {}
    for v in vars:
        value = scope.find(v.name)
        if value is None:
            continue
        arr, dtype_name = _to_numpy(value)
        arrays[v.name] = arr
        manifest[v.name] = {'dtype': dtype_name, 'shape': list(arr.shape)}
    return arrays, manifest


# Serializes snapshot installs within this process: overlapping saves
# (an async writer still in flight when the next save starts) must not
# interleave their renames in one dirname.
_SAVE_LOCK = threading.Lock()


def _write_atomic(path, write_fn, mode='wb'):
    """Write through a unique tmp file in the target directory, then
    rename: concurrent writers never share a tmp."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or '.',
                               prefix=os.path.basename(path) + '.')
    try:
        with os.fdopen(fd, mode) as f:
            write_fn(f)
        # mkstemp creates 0600; restore the umask's permissions
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _sha1_of(path):
    h = hashlib.sha1()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def _write_snapshot_locked(dirname, arrays, manifest, filename=None):
    """The disk half of a save (the caller holds _SAVE_LOCK). Returns the
    sha1 of the installed (manifest, params) files."""
    os.makedirs(dirname, exist_ok=True)
    params_path = os.path.join(dirname, filename or _PARAMS_FILE)
    if not params_path.endswith('.npz'):
        params_path += '.npz'
    man_path = os.path.join(dirname, _MANIFEST_FILE)
    _write_atomic(man_path,
                  lambda f: f.write(json.dumps(manifest,
                                               indent=1).encode()))
    _write_atomic(params_path, lambda f: np.savez(f, **arrays))
    return _sha1_of(man_path), _sha1_of(params_path)


def _write_snapshot(dirname, arrays, manifest, filename=None):
    with _SAVE_LOCK:
        return _write_snapshot_locked(dirname, arrays, manifest, filename)


# ------------------------------------------------------ vars and params
def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    main_program = main_program or default_main_program()
    arrays, manifest = _snapshot_vars(main_program, vars, predicate)
    _write_snapshot(dirname, arrays, manifest, filename)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load the requested vars that the file holds into the global scope,
    in place where the scope already holds a tensor of that shape, dtype
    and device; others are set on the executor's device (the host when
    no executor is given)."""
    main_program = main_program or default_main_program()
    path = os.path.join(dirname, filename or _PARAMS_FILE)
    if not path.endswith('.npz'):
        path += '.npz'
    with open(os.path.join(dirname, _MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    device = executor.device if executor is not None else \
        torch.device('cpu')
    scope = global_scope()
    wanted = {v.name: v for v in vars}
    with np.load(path) as data:
        for name in data.files:
            var = wanted.get(name)
            if var is None:
                continue
            value = _from_numpy(data[name], manifest[name]['dtype'])
            _restore_into(scope, name, value, device,
                          to_torch_dtype(var.dtype))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable,
              filename=filename)


# ---------------------------------------------------- inference models
def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    test_program = main_program.clone(for_test=True)
    return test_program.prune(target_vars)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Write the pruned test program (``__model__.json``) and the
    program's persistables; returns the inference program."""
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    inference_program = get_inference_program(target_vars, main_program)
    os.makedirs(dirname, exist_ok=True)
    from .core.serialize import program_to_dict
    meta = {
        'feed_names': list(feeded_var_names),
        'fetch_names': [v.name if not isinstance(v, str) else v
                        for v in target_vars],
        'program': program_to_dict(inference_program),
    }
    _write_atomic(os.path.join(dirname, model_filename or '__model__.json'),
                  lambda f: f.write(json.dumps(meta).encode()))
    save_persistables(executor, dirname, main_program,
                      filename=params_filename)
    return inference_program


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch vars) of a saved inference model, its
    persistables loaded into the global scope on the executor's device."""
    with open(os.path.join(dirname,
                           model_filename or '__model__.json')) as f:
        meta = json.load(f)
    from .core.serialize import program_from_dict
    program = program_from_dict(meta['program'])
    load_vars(executor, dirname, program, predicate=_is_persistable,
              filename=params_filename)
    fetch_vars = [program.global_block().var(n) for n in meta['fetch_names']]
    return program, meta['feed_names'], fetch_vars


# --------------------------------------------------------- checkpoints
class AsyncSaveHandle(object):
    """Returned by save_checkpoint(async_save=True). result() joins the
    writer thread and re-raises any write error."""

    def __init__(self, thread, errbox):
        self._thread = thread
        self._errbox = errbox

    def done(self):
        return not self._thread.is_alive()

    def result(self, timeout=None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError('checkpoint write still in progress')
        if self._errbox:
            raise self._errbox[0]


def save_checkpoint(executor, dirname, main_program=None, step=None,
                    reader=None, async_save=False, trainer_state=None,
                    reader_pending=0):
    """Full training checkpoint: every persistable, optimizer state
    included, and checkpoint.json (written last) with ``step``, the
    reader's position (a reader.CheckpointableReader, ``reader_pending``
    items pulled but not trained replayed on resume), ``trainer_state``
    (recorded as meta['trainer']), the topology and both files' sha1.

    Every tensor is copied to the host before this returns. With
    ``async_save`` the write runs on a thread and an AsyncSaveHandle is
    returned (its result() is the completeness point); else None."""
    main = main_program or default_main_program()
    meta = {}
    if step is not None:
        meta['step'] = int(step)
    if reader is not None:
        meta['reader'] = reader.state_dict(pending=reader_pending)
    if trainer_state is not None:
        meta['trainer'] = dict(trainer_state)
    hosts, sizes = current_topology(main)
    meta['format_version'] = CHECKPOINT_FORMAT_VERSION
    meta['mesh'] = sizes
    meta['hosts'] = hosts

    def _install(arrays, manifest):
        # the snapshot and the meta land under one lock: two overlapping
        # saves cannot pair one's params with the other's checkpoint.json
        with _SAVE_LOCK:
            man_sha, params_sha = _write_snapshot_locked(
                dirname, arrays, manifest)
            meta['manifest_sha1'] = man_sha
            meta['params_sha1'] = params_sha
            path = os.path.join(dirname, 'checkpoint.json')
            _write_atomic(path,
                          lambda f: f.write(json.dumps(meta).encode()))

    arrays, manifest = _snapshot_vars(main, predicate=_is_persistable)
    if not async_save:
        _install(arrays, manifest)
        return None
    errbox = []

    def _writer():
        try:
            _install(arrays, manifest)
        except BaseException as e:  # surfaced through handle.result()
            errbox.append(e)

    t = threading.Thread(target=_writer, daemon=True,
                         name='paddle_tpu_torch_async_save')
    t.start()
    return AsyncSaveHandle(t, errbox)


def verify_checkpoint(dirname):
    """The parsed checkpoint.json of a complete checkpoint (both recorded
    sha1s match the files); raises ValueError for a missing or torn one
    (fault.CheckpointManager then falls back to an older one)."""
    path = os.path.join(dirname, 'checkpoint.json')
    try:
        with open(path) as f:
            recorded = json.load(f)
    except FileNotFoundError:
        raise ValueError(
            'verify_checkpoint: %r holds no checkpoint.json — not a '
            '(complete) checkpoint directory' % dirname)
    except ValueError:
        raise ValueError(
            'verify_checkpoint: %r is a torn/incomplete checkpoint — '
            'checkpoint.json does not parse' % dirname)
    for key, fname in (('params_sha1', _PARAMS_FILE),
                       ('manifest_sha1', _MANIFEST_FILE)):
        want = recorded.get(key)
        if want is None:
            continue
        fpath = os.path.join(dirname, fname)
        try:
            missing = not os.path.exists(fpath)
            mismatch = (not missing) and _sha1_of(fpath) != want
        except FileNotFoundError:
            missing, mismatch = True, False
        if missing or mismatch:
            reason = 'is missing' if missing else \
                'does not match the sha1 recorded in checkpoint.json'
            raise ValueError(
                'load_checkpoint: %r is a torn/incomplete checkpoint '
                '— %s %s (a save was interrupted between renames, or '
                'the directory was partially copied). Restore from '
                'an older checkpoint; resuming here would pair '
                'weights with the wrong step/reader state.'
                % (dirname, fname, reason))
    return recorded


def load_checkpoint(executor, dirname, main_program=None, reader=None):
    """Restore a checkpoint into the global scope (in place, see
    load_vars); with ``reader`` (a CheckpointableReader) its position
    too. Returns the recorded step (None for a directory without
    checkpoint.json, restored unverified with a warning). A checkpoint
    recorded on another topology raises NotImplementedError."""
    main = main_program or default_main_program()
    path = os.path.join(dirname, 'checkpoint.json')
    meta = None
    if os.path.exists(path):
        meta = verify_checkpoint(dirname)
    elif reader is not None:
        raise ValueError(
            'load_checkpoint: a reader was passed but %r holds no '
            'checkpoint.json — resuming would silently re-consume '
            'already-trained data (was save_checkpoint called with '
            'reader=...?)' % dirname)
    if topology_changed(meta, main):
        rec = checkpoint_topology(meta) or (1, {})
        raise NotImplementedError(
            'load_checkpoint: %r was recorded on topology %s, the port '
            'restores on %s: %s'
            % (dirname, topology_str(*rec),
               topology_str(*current_topology(main)), _RESHARD_TODO))
    if meta is None:
        warnings.warn(
            'load_checkpoint: %r holds no checkpoint.json — restoring '
            'WITHOUT sha1 verification; a torn write or partial copy '
            'would go undetected here' % dirname)
    load_persistables(executor, dirname, main)
    if meta is None:
        return None
    if reader is not None:
        state = meta.get('reader')
        if state is None:
            raise ValueError(
                'load_checkpoint: a reader was passed but %r holds no '
                'reader state (was save_checkpoint called with '
                'reader=...?)' % dirname)
        reader.load_state_dict(state)
    return meta.get('step')
