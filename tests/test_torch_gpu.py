"""The port on a CUDA card: each kernel against its plain version, the
decode engine on the card against the same engine on the host, one
training step of a small Transformer and of a small ResNet on the card
against the same step on the host.

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
from paddle_tpu_torch.ops.kernels import batch_norm as tbn
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


def _paged_args(cuda, dtype, lens, broadcast=False, nb=192, h=4, bs=32,
                d=64, dv=None, p=16, seed=2, empty=()):
    """Pages, a query per row and tables whose entries past a row's pages
    are >= NB (never to be read)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    dv = d if dv is None else dv
    n = len(lens)
    kp = torch.randn(nb, h, bs, d, generator=gen, device=cuda).to(dtype)
    vp = torch.randn(nb, h, bs, dv, generator=gen, device=cuda).to(dtype)
    q = torch.randn(n, h, d, generator=gen, device=cuda)
    perm = torch.randperm(nb, generator=gen, device=cuda).to(torch.int32)
    if broadcast:
        row = perm[:p].clone()
        row[-(-max(lens) // bs):] = nb
        tables = row.expand(n, p)
    else:
        assert n * p <= nb
        tables = perm[:n * p].reshape(n, p).clone()
        for i, ln in enumerate(lens):
            tables[i, -(-ln // bs):] = nb + 3
        for i in empty:
            tables[i] = nb
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32,
                                           device=cuda)


def _paged_check(args, dtype):
    """The kernel against both plain versions: the one-pass softmax (its
    output rounded to the page dtype) and the split version that follows
    the kernel's order (fp32 output). fp32 5e-5; bf16 2e-2 + 2e-2*|plain|
    (p rounded to bf16 at different points)."""
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*args)
    assert tpa.paged_attention.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    lens = args[-1]
    for ref in (tpa.paged_attention_reference(*args).float(),
                tpa.paged_attention_split_reference(*args)):
        ref = torch.where((lens > 0)[:, None, None], ref,
                          torch.zeros_like(ref))   # empty rows give 0
        if dtype == torch.float32:
            assert float((out - ref).abs().max()) <= 5e-5
        else:
            assert bool(((out - ref).abs() <= 2e-2 + 2e-2 * ref.abs()).all())
    return out


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_paged_attention_all_splits_live_and_chunk_boundaries(cuda, dtype):
    """Rows that fill every split (P * bs tokens), rows that end on, one
    before and one past a 256-token chunk boundary, a one-token row and
    an empty slot."""
    lens = [512, 512, 255, 256, 257, 511, 1, 33, 1]
    args = _paged_args(cuda, dtype, lens, empty=(8,))
    args[-1][8] = 0
    _paged_check(args, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_paged_attention_prefill_512_rows_broadcast_table(cuda, dtype):
    """The largest prefill bucket: 512 rows against one table row (stride
    0), lengths 1..512; most splits are dead. The workspace is pre-filled
    with NaN: the merge must never touch a partial no block wrote."""
    args = _paged_args(cuda, dtype, list(range(1, 513)), broadcast=True,
                       h=8, p=64, nb=128)
    assert args[3].stride(0) == 0
    out = _paged_check(args, dtype)
    nz = -(-64 // tpa.chunk_pages(32))
    ws = torch.full((512, 8, nz, 64 + 2), float('nan'), device=cuda)
    again = tpa._paged_cuda(*args, 64 ** -0.5, workspace=ws)
    torch.cuda.synchronize()
    assert torch.equal(again, out)
    assert bool(torch.isnan(ws[0, :, 1:]).all())     # dead splits untouched


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_paged_attention_rows_do_not_depend_on_the_batch(cuda, dtype):
    """The same (q row, pages, table row, length) in a 16-row decode
    batch, alone, and inside a 128-row broadcast-table call: bit-equal
    output rows."""
    lens = [1, 40, 300, 512, 257, 256, 64, 31] * 2
    q, kp, vp, tables, sl = _paged_args(cuda, dtype, lens, nb=512, p=16)
    full = tpa.paged_attention(q, kp, vp, tables, sl)
    for i in (1, 2, 3, 4):
        alone = tpa.paged_attention(q[i:i + 1], kp, vp, tables[i:i + 1],
                                    sl[i:i + 1])
        assert torch.equal(alone[0], full[i])
        qs = torch.randn(128, *q.shape[1:], device=cuda)
        qs[77] = q[i]
        ls = torch.randint(1, 513, (128,), dtype=torch.int32, device=cuda)
        ls[77] = sl[i]
        # the row's table, with real pages wherever another row may read
        row = tables[i].clone()
        row[row >= kp.shape[0]] = 5
        many = tpa.paged_attention(qs, kp, vp, row.expand(128, 16), ls)
        assert torch.equal(many[77], full[i])


# (dtype, D, Dv, bs, P): a key row on 32 lanes, on 1 lane, D != Dv, pages
# of several tiles, a page size that is no power of two, a chunk of one page
PAGED_SHAPES = [
    (torch.float32, 128, 128, 16, 8), (torch.bfloat16, 8, 8, 32, 8),
    (torch.bfloat16, 64, 32, 32, 8), (torch.float32, 32, 64, 16, 8),
    (torch.float32, 64, 64, 128, 4), (torch.bfloat16, 64, 64, 48, 8),
    (torch.bfloat16, 128, 128, 128, 3), (torch.float32, 16, 16, 512, 2),
]


@pytest.mark.parametrize('case', PAGED_SHAPES)
def test_paged_attention_kernel_shapes(cuda, case):
    dtype, d, dv, bs, p = case
    top = p * bs
    lens = [1, bs - 1, bs, bs + 1, top, top - 1, max(1, top // 2), 1]
    args = _paged_args(cuda, dtype, lens, nb=8 * p, h=2, bs=bs, d=d, dv=dv,
                       p=p, empty=(7,))
    args[-1][7] = 0
    _paged_check(args, dtype)


def test_paged_attention_wrapper_names_what_its_loads_need(cuda):
    """Key rows that are no multiple of 16 bytes raise with the reason;
    nothing falls back to the plain version."""
    args = _paged_args(cuda, torch.bfloat16, [5, 9], nb=8, h=1, bs=8, d=12,
                       p=2)
    before = tpa.paged_attention.launches
    with pytest.raises(ValueError, match='16'):
        tpa.paged_attention(*args)
    assert tpa.paged_attention.launches == before


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


@pytest.mark.parametrize('case', [
    (4, 2, 64, 16, False, 'full'), (64, 8, 64, 64, True, 'full'),
    (2, 3, 200, 64, True, 'uniform'), (2, 2, 130, 128, False, 'uniform'),
    (2, 2, 70, 48, True, 'uniform'), (1, 1, 1, 32, False, 'full'),
])
def test_flash_forward_bf16_runs_on_the_tensor_cores(cuda, case):
    """bf16 with a head dim that is a multiple of 16 takes the tensor-core
    kernel (its counter moves, the SIMT one does not) and agrees with both
    plain versions: the whole-row softmax and the 64-key tiled one that
    rounds p as the kernel does; twice, for a copy that was not waited
    for would show as rare wrong values."""
    b, h, t, d, causal, kv = case
    q, k, v, _, lens = _flash_inputs(cuda, b, h, t, d, torch.bfloat16, kv,
                                     seed=4)
    ref_out, ref_lse = tfa.flash_attention_reference_fwd(q, k, v, lens,
                                                         causal)
    til_out, til_lse = tfa.flash_attention_tiled_reference_fwd(q, k, v, lens,
                                                               causal)
    outs = []
    for _ in range(2):
        n_mma = tfa.flash_fwd_cuda.launches_mma
        n_simt = tfa.flash_fwd_cuda.launches_simt
        out, lse = tfa.flash_attention_fwd(q, k, v, lens, causal)
        torch.cuda.synchronize()
        assert tfa.flash_fwd_cuda.launches_mma == n_mma + 1
        assert tfa.flash_fwd_cuda.launches_simt == n_simt
        _close(out, ref_out, torch.bfloat16)
        _close(out, til_out, torch.bfloat16)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse, til_lse, rtol=1e-5, atol=1e-5)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


def test_flash_forward_other_inputs_take_the_simt_kernel(cuda):
    """fp32, a bf16 head dim that is no multiple of 16, and a bf16 view
    that starts one element into its storage (its 16-byte loads would be
    misaligned) go to the SIMT kernel, and are right there."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.randn(3, 1 + 2 * 2 * 70 * 64, generator=gen, device=cuda) \
        .to(torch.bfloat16)
    shifted = [flat[i, 1:].view(2, 2, 70, 64) for i in range(3)]
    odd = [torch.randn(2, 2, 70, 40, generator=gen, device=cuda)
           .to(torch.bfloat16) for _ in range(3)]
    fp32 = [torch.randn(2, 2, 70, 64, generator=gen, device=cuda)
            for _ in range(3)]
    for q, k, v in (shifted, odd, fp32):
        n_mma = tfa.flash_fwd_cuda.launches_mma
        n_simt = tfa.flash_fwd_cuda.launches_simt
        out, lse = tfa.flash_attention_fwd(q, k, v, None, True)
        torch.cuda.synchronize()
        assert tfa.flash_fwd_cuda.launches_mma == n_mma
        assert tfa.flash_fwd_cuda.launches_simt == n_simt + 1
        ref_out, ref_lse = tfa.flash_attention_reference_fwd(q, k, v, None,
                                                             True)
        _close(out, ref_out, q.dtype)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


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


def _bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at |x|, elementwise."""
    a = x.abs().double().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _bn_check(x, layout, gen):
    """K5 against its plain version on x: mean 1e-5 and var 1e-4 relative
    (fp32 sums in another order); y fp32 1e-4; y bf16 within one bf16 ulp
    each of x·a, b and y (a and b, computed from statistics 1e-6 apart,
    may round to the neighbouring bf16 value)."""
    c = x.shape[1] if layout == 'NCHW' else x.shape[-1]
    s = 0.5 + torch.rand(c, generator=gen, device=x.device)
    b = torch.randn(c, generator=gen, device=x.device)
    before = tbn.fused_batch_norm_train.launches
    y, m, v = tbn.fused_batch_norm_train(x, s, b, 1e-5, layout=layout)
    assert tbn.fused_batch_norm_train.launches == before + 1
    x4 = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
    x3 = x4.reshape(x4.shape[0], c, -1) if x.dim() == 4 else x.unsqueeze(-1)
    ry, rm, rv = tbn._bn_reference(x3, s, b, 1e-5)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape
    assert [st for st, n in zip(y.stride(), y.shape) if n > 1] == \
        [st for st, n in zip(x.stride(), x.shape) if n > 1]
    torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-5)
    y4 = y.permute(0, 3, 1, 2) if layout == 'NHWC' else y
    y3 = y4.reshape(ry.shape) if x.dim() == 4 else y.unsqueeze(-1)
    if x.dtype == torch.float32:
        torch.testing.assert_close(y3, ry, rtol=1e-4, atol=1e-4)
        return
    a = s * torch.rsqrt(rv + 1e-5)
    xa = (x3.float() * a[:, None]).abs()
    bb = (b - rm * a)[:, None].abs()
    tol = _bf16_ulp(xa) + _bf16_ulp(bb) + _bf16_ulp(ry.float())
    assert bool(((y3.double() - ry.double()).abs() <= tol).all())


# (layout, shape, dtype): ResNet-50's stem at batch 64, an NCHW shape of
# the network, and shapes off every fast path (odd C, planes of 49 and 9
# elements, C = 1, one row)
BN_CASES = [
    ('NHWC', (64, 112, 112, 64), torch.bfloat16),
    ('NCHW', (64, 128, 28, 28), torch.bfloat16),
    ('NHWC', (64, 7, 7, 2048), torch.bfloat16),
    ('NHWC', (8, 56, 56, 256), torch.float32),
    ('NC', (1003, 100), torch.float32),
    ('NCHW', (8, 2048, 7, 7), torch.float32),
    ('NCHW', (3, 5, 3, 3), torch.bfloat16),
    ('NHWC', (2, 3, 3, 1), torch.float32),
    ('NC', (1, 7), torch.float32),
]


@pytest.mark.parametrize('case', BN_CASES)
def test_batch_norm_kernel_matches_plain(cuda, case):
    layout, shape, dtype = case
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    _bn_check(x, layout, gen)


def test_batch_norm_kernel_takes_channels_last_nchw_and_offsets(cuda):
    """An NCHW tensor with channels-last strides takes the rows order; a
    view at an odd element offset takes the one-element path."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(4, 64, 10, 10, generator=gen, device=cuda) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    _bn_check(x, 'NCHW', gen)
    flat = torch.randn(1 + 32 * 24, generator=gen, device=cuda)
    _bn_check(flat[1:].view(32, 24), 'NC', gen)


def test_batch_norm_gradient_matches_autograd_of_plain(cuda):
    """The closed-form backward against autograd through the plain
    version, fp32: 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(16, 9, 9, 32, generator=gen, device=cuda)
    s = 0.5 + torch.rand(32, generator=gen, device=cuda)
    b = torch.randn(32, generator=gen, device=cuda)
    gy = torch.randn(x.shape, generator=gen, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    y, _, _ = tbn.fused_batch_norm_train(*leaves, 1e-5, layout='NHWC')
    got = torch.autograd.grad(y, leaves, gy)
    ref_leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    x3 = ref_leaves[0].permute(0, 3, 1, 2).reshape(16, 32, 81)
    ry, _, _ = tbn._bn_reference(x3, ref_leaves[1], ref_leaves[2], 1e-5)
    want = torch.autograd.grad(ry, ref_leaves,
                               gy.permute(0, 3, 1, 2).reshape(16, 32, 81))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_batch_norm_wrapper_rejects_bad_inputs(cuda):
    x = torch.zeros(4, 8, 3, 3, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        tbn.fused_batch_norm_train(x.half(), s, s, 1e-5, layout='NCHW')
    with pytest.raises(ValueError):
        tbn.fused_batch_norm_train(x, s.double(), s, 1e-5, layout='NCHW')
    with pytest.raises(ValueError):
        tbn.fused_batch_norm_train(x, s[:4], s[:4], 1e-5, layout='NCHW')
    with pytest.raises(ValueError):           # channels not dense
        tbn.fused_batch_norm_train(x[:, ::2], s[:4], s[:4], 1e-5,
                                   layout='NCHW')


def test_resnet_training_step_on_card_equals_host(cuda):
    """Two Momentum steps of a small bottleneck ResNet (fp32, NHWC and
    NCHW) from the same weights on the card and on the host: losses to
    1e-4 relative, parameters and running statistics within 1e-4; every
    batch norm of the card's steps ran K5."""
    from paddle_tpu_torch.models import resnet as R
    from paddle_tpu_torch.weights import load_into_scope
    feed = R.make_fake_batch(8, 16, 10, seed=3)
    for layout in ('NHWC', 'NCHW'):
        pt.reset_default_programs()
        img = pt.layers.data(name='image', shape=[3, 16, 16],
                             dtype='float32')
        label = pt.layers.data(name='label', shape=[1], dtype='int64')
        h = pt.layers.transpose(img, [0, 2, 3, 1]) if layout == 'NHWC' \
            else img
        h = R.conv_bn_layer(h, 16, 3, 1, 1, data_format=layout)
        h = pt.layers.pool2d(h, pool_size=3, pool_type='max', pool_stride=2,
                             pool_padding=1, data_format=layout)
        h = R.layer_warp(R.bottleneck, h, 8, 2, 2, data_format=layout)
        h = pt.layers.pool2d(h, pool_type='avg', global_pooling=True,
                             data_format=layout)
        avg = pt.layers.mean(pt.layers.cross_entropy(
            pt.layers.fc(h, size=10, act='softmax'), label))
        pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
            .minimize(avg)
        main = pt.default_main_program()
        host = pt.Scope()
        with pt.scope_guard(host):
            pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
        weights = {n: host.numpy(n) for n in host.keys()}
        losses, scopes = [], []
        for place in (pt.CUDAPlace(0), pt.CPUPlace()):
            scope = pt.Scope()
            load_into_scope(weights, scope, place)
            before = tbn.fused_batch_norm_train.launches
            with pt.scope_guard(scope):
                exe = pt.Executor(place)
                losses.append([exe.run(main, feed=feed,
                                       fetch_list=[avg])[0].item()
                               for _ in range(2)])
            if isinstance(place, pt.CUDAPlace):
                assert tbn.fused_batch_norm_train.launches == before + 2 * 8
            scopes.append(scope)
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
        for n in weights:
            gap = np.abs(scopes[0].numpy(n) - scopes[1].numpy(n))
            assert gap.max() <= 1e-4, n


# ---- K3's two variants: the tensor-core pair (bf16, aligned) and the SIMT
# pair. chip_smoke.py's five flash cases: (B, H, T, D, dtype, causal, kv_len
# spec), kv 'one' being the masked case's lengths with the last row at 1
BWD_CASES = [
    (64, 8, 64, 64, torch.bfloat16, False, 'full'),
    (64, 8, 64, 64, torch.bfloat16, True, 'full'),
    (8, 8, 512, 64, torch.bfloat16, True, 'uniform'),
    (4, 4, 200, 128, torch.bfloat16, False, 'uniform'),
    (64, 8, 64, 64, torch.float32, False, 'full'),
]


def _bwd_counts():
    return tuple((w.launches, w.launches_mma, w.launches_simt)
                 for w in (tfa.flash_bwd_dq_cuda, tfa.flash_bwd_dkv_cuda))


def _bwd_variant(before):
    """'mma' or 'simt' when both K3 kernels launched once since ``before``
    and on the same variant, else the counter moves."""
    moved = [tuple(a - b for a, b in zip(now, was))
             for now, was in zip(_bwd_counts(), before)]
    if moved == [(1, 1, 0)] * 2:
        return 'mma'
    if moved == [(1, 0, 1)] * 2:
        return 'simt'
    return moved


@pytest.mark.parametrize('case', BWD_CASES)
def test_flash_backward_pair_matches_plain_and_repeats(cuda, case):
    """Both K3 kernels against flash_attention_reference_bwd (bf16: 1e-2 of
    the largest value plus 1e-2 relative; fp32: 1e-5), bf16 on the
    tensor-core pair and fp32 on the SIMT pair, and a second run giving the
    same bits (no atomics; a copy not waited for would show here)."""
    b, h, t, d, dtype, causal, kv = case
    q, k, v, do, lens = _flash_inputs(cuda, b, h, t, d, dtype, kv, seed=11)
    out, lse = tfa.flash_attention_fwd(q, k, v, lens, causal)
    want = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, lens,
                                             causal)
    runs = []
    for _ in range(2):
        before = _bwd_counts()
        runs.append(tfa.flash_attention_bwd(q, k, v, out, lse, do, lens,
                                            causal))
        torch.cuda.synchronize()
        assert _bwd_variant(before) == (
            'mma' if dtype == torch.bfloat16 else 'simt')
    for g, w in zip(runs[0], want):
        assert g.dtype == dtype
        _close(g, w, dtype)
    for g0, g1 in zip(*runs):
        assert torch.equal(g0, g1)


@pytest.mark.parametrize('case', [
    (2, 3, 200, 64, True, 'uniform'), (3, 2, 200, 16, False, 'uniform'),
    (2, 2, 130, 32, True, 'full'), (1, 2, 65, 64, True, 'full'),
    (2, 2, 70, 48, False, 'uniform'),
])
def test_flash_backward_tensor_cores_at_tails_and_short_rows(cuda, case):
    """T not a multiple of the 64-row tile (65: a tail of one row), head
    dims 16..64 and rows with kv_len 1, on the tensor-core pair."""
    b, h, t, d, causal, kv = case
    q, k, v, do, lens = _flash_inputs(cuda, b, h, t, d, torch.bfloat16, kv,
                                      seed=12)
    out, lse = tfa.flash_attention_fwd(q, k, v, lens, causal)
    before = _bwd_counts()
    got = tfa.flash_attention_bwd(q, k, v, out, lse, do, lens, causal)
    torch.cuda.synchronize()
    assert _bwd_variant(before) == 'mma'
    want = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, lens,
                                             causal)
    for g, w in zip(got, want):
        _close(g, w, torch.bfloat16)


def test_flash_backward_other_inputs_take_the_simt_pair(cuda):
    """fp32, a bf16 head dim that is no multiple of 16 and a bf16 view one
    element into its storage go to the SIMT pair, and are right there."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    flat = torch.randn(4, 1 + 2 * 2 * 70 * 64, generator=gen, device=cuda) \
        .to(torch.bfloat16)
    shifted = [flat[i, 1:].view(2, 2, 70, 64) for i in range(4)]
    odd = [torch.randn(2, 2, 70, 40, generator=gen, device=cuda)
           .to(torch.bfloat16) for _ in range(4)]
    fp32 = [torch.randn(2, 2, 70, 64, generator=gen, device=cuda)
            for _ in range(4)]
    for q, k, v, do in (shifted, odd, fp32):
        out, lse = tfa.flash_attention_fwd(q, k, v, None, True)
        before = _bwd_counts()
        got = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
        torch.cuda.synchronize()
        assert _bwd_variant(before) == 'simt'
        want = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, None,
                                                 True)
        for g, w in zip(got, want):
            _close(g, w, q.dtype)


def test_flash_backward_head_split_views_on_the_tensor_cores(cuda):
    """[B, H, T, D] views of [B, T, H*D] activations (the model's layout)
    take the tensor-core pair and give the bits of contiguous copies."""
    b, h, t, d = 4, 8, 128, 64
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, do = (torch.randn(b, t, h * d, generator=gen, device=cuda)
                   .to(torch.bfloat16).reshape(b, t, h, d).transpose(1, 2)
                   for _ in range(4))
    lens = torch.tensor([128, 100, 65, 1], device=cuda)
    out, lse = tfa.flash_attention_fwd(q, k, v, lens, False)
    before = _bwd_counts()
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, lens, False)
    assert _bwd_variant(before) == 'mma'
    assert all(g.stride() == x.stride() for g, x in zip(grads, (q, k, v)))
    refs = tfa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), out.contiguous(), lse,
                                   do.contiguous(), lens, False)
    for g, r in zip(grads, refs):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


# ---- K5's single cooperative launch: (layout, shape, dtype, on chip): x
# staged in shared memory (read once) or walked twice, in both orders
BN_ONE_LAUNCH_CASES = [
    ('NHWC', (64, 7, 7, 2048), torch.bfloat16, True),
    ('NHWC', (64, 56, 56, 64), torch.bfloat16, True),
    ('NHWC', (64, 112, 112, 64), torch.bfloat16, False),
    ('NCHW', (64, 128, 28, 28), torch.bfloat16, True),
    ('NCHW', (64, 256, 56, 56), torch.bfloat16, False),
    ('NCHW', (8, 2048, 7, 7), torch.float32, True),
    ('NC', (1003, 100), torch.float32, True),
    ('NHWC', (3, 37, 11, 2048), torch.bfloat16, True),
]


@pytest.mark.parametrize('case', BN_ONE_LAUNCH_CASES)
def test_batch_norm_one_launch_on_and_off_chip_repeats(cuda, case):
    """One launch a call, staged on chip where the plan says it fits,
    within the plain version's tolerances, and the same bits twice."""
    layout, shape, dtype, on_chip = case
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    c = shape[1] if layout == 'NCHW' else shape[-1]
    x4 = x.permute(0, 3, 1, 2) if layout == 'NHWC' else x
    x3 = x4.reshape(x4.shape[0], c, -1) if x.dim() == 4 else x.unsqueeze(-1)
    plan = tbn.launch_plan(x3)
    assert bool(plan['on_chip']) == on_chip
    assert plan['blocks'] <= plan['card_blocks']
    _bn_check(x, layout, gen)
    s = 0.5 + torch.rand(c, generator=gen, device=cuda)
    b = torch.randn(c, generator=gen, device=cuda)
    runs = []
    for _ in range(2):
        before = tbn.fused_batch_norm_train.launches
        runs.append(tbn.fused_batch_norm_train(x, s, b, 1e-5, layout=layout))
        assert tbn.fused_batch_norm_train.launches == before + 1
    torch.cuda.synchronize()
    for r0, r1 in zip(*runs):
        assert torch.equal(r0, r1)


def test_batch_norm_cooperative_launch_captures_into_a_graph(cuda):
    """The cooperative launch records into a CUDA graph (chip_smoke.py
    times kernels by graph replay) and the replay gives the eager bits."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(64, 14, 14, 1024, generator=gen, device=cuda) \
        .to(torch.bfloat16)
    s = 0.5 + torch.rand(1024, generator=gen, device=cuda)
    b = torch.randn(1024, generator=gen, device=cuda)
    want = tbn.fused_batch_norm_train(x, s, b, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tbn.fused_batch_norm_train(x, s, b, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tbn.fused_batch_norm_train(x, s, b, 1e-5)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
