"""SE-ResNeXt-50 (cardinality 8, 32x32, batch 4, 10 classes), port
against reference: the first Momentum step from the reference startup's
weights at fp32 (tests/test_torch_cnn_models.py's first_step_matches;
the JAX package's batch norm on its Pallas kernel, in interpret mode).
At this build the last stage normalizes 4 values a channel: with the
images scaled by 1 + 2^-23 the first loss moves by 8e-5 in the port and
7.5e-5 in the reference, the second by 18-34 %
(tests/torch_cnn_conditioning.py; PERF.md keeps the readings)."""

import pytest

from test_torch_cnn_models import first_step_matches

CASE = ('se_resnext', 'resnext', 'se_resnext', 32, 4,
        dict(class_dim=10, depth=50, cardinality=8))


@pytest.fixture(autouse=True)
def _jax_bn_on_its_kernel(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_BN_PALLAS', '1')
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


def test_se_resnext_first_step_matches_reference():
    """53 convolutions (16 grouped), 53 batch norms and 16
    squeeze-and-excitation blocks: the first loss within rtol 1e-5, the
    running statistics within 1e-4 of their largest entry, the first
    gradients within 0.2 for each parameter and 0.1 all together (nudged:
    0.025 and 0.017; other convolution sums: 0.073 and 0.042). Under
    bf16 AMP nothing is held here: the nudge alone moves the first loss
    by 3.5 %; the smoke's phase 21c holds bf16 on the card against the
    host at 64x64, batch 8."""
    first_step_matches(CASE, None, 1e-4, (0.2, 0.1))
