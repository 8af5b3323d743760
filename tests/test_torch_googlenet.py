"""GoogLeNet (64x64, batch 4, 10 classes), port against reference: 3
Momentum steps from the reference startup's weights, fp32 and bf16 AMP
(tests/test_torch_cnn_models.py's three_steps_match), dropout at 0 in
both programs. The bounds on the first step's gradients are about twice
what rounding alone gives at this build: the reference against itself
with the images scaled by 1 + 2^-23 (tests/torch_cnn_conditioning.py;
PERF.md keeps the readings)."""

import pytest

from test_torch_cnn_models import three_steps_match

GOOGLENET = ('googlenet', 'googlenet', 'googlenet', 64, 4,
             dict(class_dim=10))


@pytest.fixture(autouse=True)
def _jax_bn_on_its_kernel(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_BN_PALLAS', '1')
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
def test_googlenet_trains_like_reference(amp):
    """57 convolutions and nine channel concats: three_steps_match at LR
    1e-3 (at 1e-2 a nudge of the reference alone moves its third loss by
    1.2e-5); the first gradients within 5e-4 for each parameter and 1e-4
    all together at fp32 (the reference against itself nudged: 1.9e-4
    and 2.5e-5, a near-tie in the stem flipping), all together within 0.2
    under bf16 (nudged: 0.070)."""
    three_steps_match(GOOGLENET, amp, 1e-3,
                      (5e-4, 1e-4) if amp is None else (None, 0.2))
