"""The port on a CUDA card: each kernel against its plain version, and
the decode engine on the card against the same engine on the host.

Marked ``gpu``; each test decides inside itself whether a card exists and
skips without one. This file imports no jax, so it also runs on a machine
that has only torch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops.kernels import layer_norm as tln
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from paddle_tpu_torch.serving.decode import (DecodeEngine, LMSpec,
                                             random_weights)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda', 0)


@pytest.mark.parametrize('shape', [(16, 512), (5, 100), (3, 2048)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_layer_norm_kernel_matches_plain(cuda, shape, dtype):
    """fp32: 1e-5 (same formula, other summation order); bf16: y is
    rounded once, so at most one bf16 step (2^-7 relative) apart."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, d = shape
    x = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=cuda)
    b = 0.1 * torch.randn(d, generator=gen, device=cuda)
    before = tln.fused_layer_norm.launches
    y = tln.fused_layer_norm(x, g, b)
    assert tln.fused_layer_norm.launches == before + 1
    ref = tln._ln_reference(x, g, b, 1e-5)
    assert y.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(y.float(), ref.float(), rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('broadcast', [False, True])
def test_paged_attention_kernel_matches_plain(cuda, dtype, broadcast):
    """fp32: 5e-5 (online vs one-pass softmax); bf16: 2e-2 (the plain
    version rounds its output to bf16; both round p at other points)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    nb, h, bs, d, p, n = 64, 4, 16, 32, 8, 6
    kp = torch.randn(nb, h, bs, d, generator=gen, device=cuda).to(dtype)
    vp = torch.randn(nb, h, bs, d, generator=gen, device=cuda).to(dtype)
    q = torch.randn(n, h, d, generator=gen, device=cuda)
    perm = torch.randperm(nb, generator=gen, device=cuda).to(torch.int32)
    if broadcast:
        tables = perm[:p].expand(n, p)
        lens = torch.arange(100, 100 + n, dtype=torch.int32, device=cuda)
    else:
        tables = perm[:n * p].reshape(n, p).clone()
        tables[-1] = nb                       # an empty slot
        lens = torch.tensor([1, 15, 16, 17, 128, 1], dtype=torch.int32,
                            device=cuda)
    out = tpa.paged_attention(q, kp, vp, tables, lens)
    ref = tpa.paged_attention_reference(q, kp, vp, tables, lens).float()
    tol = 5e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def test_paged_attention_wrapper_rejects_bad_inputs(cuda):
    q = torch.zeros(2, 1, 8, device=cuda)
    pages = torch.zeros(4, 1, 4, 8, device=cuda)
    lens = torch.ones(2, dtype=torch.int32, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, pages, pages, tables, lens)   # int64 table
    with pytest.raises(ValueError):
        tpa.paged_attention(q.double(), pages, pages,
                            tables.to(torch.int32), lens)


def test_engine_on_card_equals_engine_on_host(cuda):
    spec = LMSpec(vocab_size=64, n_layer=2, n_head=2, d_key=16, d_value=16,
                  d_model=32, d_inner=64)
    geom = dict(max_batch=4, block_size=8, num_blocks=32, pages_per_seq=4)
    weights = random_weights(spec, seed=2)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 64, int(rng.randint(1, 20))).tolist()
               for _ in range(6)]
    out = {}
    for place in (pt.CUDAPlace(0), pt.CPUPlace()):
        eng = DecodeEngine(spec, place=place, weights=weights, **geom)
        eng.start()
        streams = [eng.submit(pr, max_new_tokens=8) for pr in prompts]
        out[type(place).__name__] = [s.result(timeout=120)
                                     for s in streams]
        eng.shutdown()
        assert eng.free_pages() == eng.num_blocks
    assert out['CUDAPlace'] == out['CPUPlace']
