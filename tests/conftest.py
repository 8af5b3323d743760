"""Test config: force an 8-virtual-device CPU platform BEFORE jax imports
(SURVEY.md §4), so mesh/sharding tests run without TPU hardware."""

from paddle_tpu.core.platform_boot import force_host_cpu

force_host_cpu(8)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_programs():
    import paddle_tpu as fluid
    fluid.reset_default_programs()
    fluid.global_scope().clear()
    yield


# ---- fast/slow partition (VERDICT r4 next-#8: the full suite is ~20
# min; `-m fast` is the <5-min gate for iterating). Slow = whole-model
# e2e, mesh/multihost, amp sweeps, compiled-C clients; everything else
# is fast by default so NEW test files land in the fast gate unless
# explicitly listed here.
import os as _os

_SLOW_FILES = {
    'test_models_e2e.py', 'test_parallel.py', 'test_multihost.py',
    'test_amp.py', 'test_layers.py', 'test_capi.py', 'test_staging.py',
    'test_examples.py', 'test_moe.py', 'test_gan_two_programs.py',
    'test_transformer_infer.py', 'test_transformer_scan.py',
    'test_v1compat_sweep.py', 'test_trainer_and_losses.py',
}


def pytest_configure(config):
    config.addinivalue_line('markers', 'fast: quick-gate subset (<5 min)')
    config.addinivalue_line('markers', 'slow: whole-model/mesh suites')
    config.addinivalue_line('markers', 'gpu: needs a CUDA card; skips '
                            'without one')


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = _os.path.basename(str(item.fspath))
        marker = pytest.mark.slow if fname in _SLOW_FILES else \
            pytest.mark.fast
        item.add_marker(marker)
