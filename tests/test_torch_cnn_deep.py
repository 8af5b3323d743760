"""vgg_bn_drop (CIFAR 32x32, batch 16), port against reference from the
reference startup's weights, fp32 and bf16 AMP
(tests/test_torch_cnn_models.py's first_step_matches; the JAX package's
batch norm on its Pallas kernel, in interpret mode), dropout at 0 in
both programs. The bounds on the first step's gradients are about twice
what rounding alone gives at this build: the port or the reference
against itself with the images scaled by 1 + 2^-23, or the port with
other convolution sums (tests/torch_cnn_conditioning.py; PERF.md keeps
the readings)."""

import pytest

from test_torch_cnn_models import first_step_matches

VGG = ('vgg_bn_drop', 'vgg', 'vgg_bn_drop', 32, 16, dict(class_dim=10))


@pytest.fixture(autouse=True)
def _jax_bn_on_its_kernel(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_BN_PALLAS', '1')
    monkeypatch.setenv('PADDLE_TPU_PALLAS_INTERPRET', '1')


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
def test_vgg_bn_drop_first_step_matches_reference(amp):
    """13 convolutions and 14 batch norms (one on the [16, 512] fc
    output): the first loss within rtol 1e-5 (bf16: 1e-2), the running
    statistics within 1e-4 (bf16: 5e-2) of their largest entry; the
    first gradients within 0.05 at fp32, each parameter's and all
    together (a nudge reads 0.0068 and 0.0052, other convolution sums
    0.015 and 0.011). Later steps are not held: the nudge moves the
    second loss by 3e-3 in the reference. Under bf16 the gradients are
    not held either: the nudge moves them by 38 % of their norm."""
    first_step_matches(VGG, amp, 1e-4 if amp is None else 5e-2,
                       (0.05, 0.05) if amp is None else None)
