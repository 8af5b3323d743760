"""Package rules of the port: importing every module of paddle_tpu_torch
loads neither jax nor paddle_tpu, no module calls PyTorch's fused
attention or batch norm (the flash and batch-norm kernels are the port's
own), and with no place
given the entry points want a CUDA device — without one they raise
instead of falling back to the host."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (port tests import both frameworks)
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.kernels import layer_norm as tln
from paddle_tpu_torch.serving.decode import DecodeEngine, LMSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r'''
import pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, 'paddle_tpu_torch.'):
    __import__(m.name)
bad = sorted(n for n in sys.modules
             if n == 'jax' or n.startswith('jax.') or n == 'jaxlib'
             or n.startswith('jaxlib.') or n == 'paddle_tpu'
             or n.startswith('paddle_tpu.'))
print('loaded %d modules; forbidden: %s' % (len(sys.modules), bad))
sys.exit(1 if bad else 0)
'''


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, '-c', _IMPORT_ALL], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize('script', ['chip_smoke.py', 'kernel_times.py'])
def test_chip_scripts_import_no_jax_and_no_reference(script):
    """The chip scripts run where there is no jax: every import statement
    in them (read with ast, not run) names neither jax nor paddle_tpu."""
    import ast
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names, script
    bad = [n for n in names if n.split('.')[0] in ('jax', 'jaxlib',
                                                   'paddle_tpu')]
    assert not bad, bad
    assert any(n.startswith('paddle_tpu_torch') for n in names) or \
        script == 'kernel_times.py'


def test_no_module_calls_library_attention():
    """scaled_dot_product_attention and F.batch_norm are yardsticks in
    chip_smoke.py only; no module of the port calls them, PyTorch's other
    batch-norm entry points or torch.compile."""
    pkg = os.path.join(REPO, 'paddle_tpu_torch')
    hits = []
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith('.py'):
                path = os.path.join(root, name)
                with open(path) as f:
                    text = f.read()
                for word in ('scaled_dot_product_attention',
                             'torch.compile', 'F.batch_norm',
                             'functional.batch_norm', 'torch.batch_norm',
                             'native_batch_norm', 'nn.BatchNorm'):
                    if word in text:
                        hits.append((os.path.relpath(path, REPO), word))
    assert not hits, hits


def _no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the no-card path does not '
                    'apply')


def test_default_place_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.Executor()
    with pytest.raises(RuntimeError, match='CUDA'):
        pt.CUDAPlace(0).device()
    spec = LMSpec(vocab_size=16, n_layer=1, n_head=1, d_key=4, d_value=4,
                  d_model=4, d_inner=8)
    with pytest.raises(RuntimeError, match='CUDA'):
        DecodeEngine(spec, max_batch=2, block_size=2, num_blocks=4,
                     pages_per_seq=2)


def test_cpu_place_runs_on_the_host():
    exe = pt.Executor(pt.CPUPlace())
    assert exe.device == torch.device('cpu')


def test_non_cpu_tensor_never_takes_the_plain_version():
    """The wrapper takes its plain version only for CPU tensors: any
    other device goes to the kernel path, which raises when it cannot
    launch (here: no card to launch on) instead of falling back."""
    _no_card()
    x = torch.empty(4, 8, device='meta')
    g = torch.empty(8, device='meta')
    before = tln.fused_layer_norm.launches
    with pytest.raises(RuntimeError):
        tln.fused_layer_norm(x, g, g)
    assert tln.fused_layer_norm.launches == before


def test_feeds_and_fetches_cross_the_host_boundary():
    """Executor.run turns numpy feeds into tensors of the declared dtype on
    the place and hands fetches back as numpy."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        pt.layers.create_parameter(
            shape=[3], dtype='float32', name='w',
            attr=pt.ParamAttr(name='w',
                              initializer=pt.initializer.Constant(2.5)))
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(program=startup)
    np.testing.assert_array_equal(scope.numpy('w'), np.full(3, 2.5, 'f'))
    assert scope.get('w').device == torch.device('cpu')
