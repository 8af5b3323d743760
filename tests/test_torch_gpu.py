"""The port on a CUDA card: each kernel against its plain version, the
decode engine on the card against the same engine on the host, and one
training step of a small Transformer on the card against the same step
on the host.

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
from paddle_tpu_torch.ops.kernels import flash_attention as tfa
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


# (B, H, T, D, dtype, causal, kv_len spec): the training path's shapes
# (encoder, decoder, the masked seq-512 bench shape), an fp32 case, tails
# that are not a multiple of the 64-row tile, and the widest head dim
FLASH_CASES = [
    (64, 8, 64, 64, torch.bfloat16, False, 'full'),
    (64, 8, 64, 64, torch.bfloat16, True, 'full'),
    (8, 8, 512, 64, torch.bfloat16, True, 'uniform'),
    (8, 8, 512, 64, torch.float32, False, 'uniform'),
    (3, 2, 70, 40, torch.float32, True, 'uniform'),
    (2, 3, 130, 128, torch.bfloat16, False, 'uniform'),
]


def _flash_inputs(cuda, b, h, t, d, dtype, kv, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    lens = None
    if kv == 'uniform':
        lens = torch.randint(t // 2, t + 1, (b,), generator=gen,
                             device=cuda)
        lens[-1] = 1
    return q, k, v, do, lens


def _close(got, want, dtype):
    """fp32: sums in another order, 1e-5 of the largest value; bf16: the
    outputs are rounded to bf16 and p is rounded per tile against the
    running max, so 1e-2 of the largest value plus 1e-2 relative."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5 * max(top, 1.0)
    else:
        assert bool(((got - want).abs() <=
                     1e-2 * top + 1e-2 * want.abs()).all())


@pytest.mark.parametrize('case', FLASH_CASES)
def test_flash_kernels_match_plain(cuda, case):
    b, h, t, d, dtype, causal, kv = case
    q, k, v, do, lens = _flash_inputs(cuda, b, h, t, d, dtype, kv)
    n_fwd = tfa.flash_fwd_cuda.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, lens, causal)
    assert tfa.flash_fwd_cuda.launches == n_fwd + 1
    ref_out, ref_lse = tfa.flash_attention_reference_fwd(q, k, v, lens,
                                                         causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    n_bwd = (tfa.flash_bwd_dkv_cuda.launches, tfa.flash_bwd_dq_cuda.launches)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, lens, causal)
    assert (tfa.flash_bwd_dkv_cuda.launches,
            tfa.flash_bwd_dq_cuda.launches) == (n_bwd[0] + 1, n_bwd[1] + 1)
    want = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, lens,
                                             causal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _close(g, w, dtype)


def test_flash_kernels_take_head_split_views(cuda):
    """q, k, v as [B, H, T, D] views of [B, T, H*D] activations (the
    fused_attention op's layout): same result as contiguous copies, and
    the outputs keep the inputs' memory layout."""
    b, h, t, d = 4, 8, 64, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(b, t, h * d, generator=gen, device=cuda)
                   .to(torch.bfloat16).reshape(b, t, h, d).transpose(1, 2)
                   for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, None, True)
    assert out.stride() == q.stride()
    ref, _ = tfa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                     v.contiguous(), None, True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
    refs = tfa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), out, lse, do.contiguous(),
                                   None, True)
    for g, r in zip(grads, refs):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q = torch.zeros(2, 2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q.cpu(), q)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, q[:, :, :4], q[:, :, :4], causal=True)
    wide = torch.zeros(1, 1, 8, 192, device=cuda)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(wide, wide, wide)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q[..., ::2], q[..., ::2], q[..., ::2])


def test_training_step_on_card_equals_host(cuda):
    """Two Adam steps of a small transformer_base (fp32, no dropout) from
    the same weights on the card and on the host: losses to 1e-5
    relative, parameters within Adam's 2·lr·steps; the card's step ran
    the flash and layer-norm kernels."""
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    pt.reset_default_programs()
    avg_cost, _ = T.transformer_base(
        src_vocab_size=96, trg_vocab_size=96, src_seq_len=24,
        trg_seq_len=24, n_layer=2, n_head=4, d_key=16, d_value=16,
        d_model=64, d_inner=128, dropout_rate=0.0)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    main = pt.default_main_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    feed = T.make_fake_batch(3, 24, 24, 96, 96, seed=2)
    feed['src_length'] = np.array([24, 17, 1], 'int64')
    losses, scopes = [], []
    for place in (pt.CUDAPlace(0), pt.CPUPlace()):
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        before = tfa.flash_bwd_dq_cuda.launches
        with pt.scope_guard(scope):
            exe = pt.Executor(place)
            losses.append([float(exe.run(main, feed=feed,
                                         fetch_list=[avg_cost])[0])
                           for _ in range(2)])
        if isinstance(place, pt.CUDAPlace):
            assert tfa.flash_bwd_dq_cuda.launches == before + 2 * 3 * 2
        scopes.append(scope)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for p in main.all_parameters():
        if p.trainable:
            gap = np.abs(scopes[0].numpy(p.name) - scopes[1].numpy(p.name))
            assert gap.max() <= 2 * 1e-3 * 2, p.name
