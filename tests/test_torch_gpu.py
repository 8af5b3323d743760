"""The port on a CUDA card: each kernel against its plain version, the
decode engine on the card against the same engine on the host, one
training step of a small Transformer and of a small ResNet on the card
against the same step on the host, the NMT inference graphs (greedy
and beam, unrolled and incremental) on the card against the host, and
the training lifecycle: a captured step with an LR schedule, a
global-norm clip and L2 decay against eager, a checkpoint restored into
a live executor (a replay), and a Trainer's resume, bit for bit.

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
from chip_smoke import LAYERS_EDGE, LAYERS_FAULTS, ordinary, parity_difference
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
    """Key rows that are no multiple of 16 bytes take the any-width kernel
    (its narrower loads), and so do rows wider than 256 elements (once the
    one refusal; now walked in 256-column chunks); nothing falls back to
    the plain version."""
    for d in (12, 264):
        args = _paged_args(cuda, torch.bfloat16, [5, 9], nb=8, h=1, bs=8,
                           d=d, p=2)
        before = tpa.paged_attention.launches_any
        _paged_check(args, torch.bfloat16)
        assert tpa.paged_attention.launches_any == before + 1


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
    wide = torch.zeros(1, 1, 8, 264, device=cuda)   # taken: no refusal
    out, _ = tfa.flash_attention_fwd(wide, wide, wide)
    assert bool((out == 0).all())
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


# ---- the inputs the JAX op's default path takes: causal with Tq != Tk
# (aligned bottom-right), rows with no live key (the mean of V), head dims
# above 128 (the SIMT kernels, query tiles of 32 in the backward)
FAULT_CASES = [
    # (B, H, Tq, Tk, D, dtype, causal, kv_len or None)
    (2, 2, 48, 64, 64, torch.bfloat16, True, None),
    (2, 2, 64, 48, 64, torch.bfloat16, True, None),
    (2, 2, 130, 70, 32, torch.float32, True, [70, 30]),
    (3, 2, 100, 100, 64, torch.bfloat16, False, [100, 0, 7]),
    (3, 2, 100, 100, 16, torch.float32, True, [0, 100, 50]),
    (2, 2, 150, 150, 192, torch.float32, False, [150, 80]),
    (2, 2, 150, 120, 192, torch.bfloat16, True, None),
    (2, 2, 77, 77, 256, torch.float32, True, [77, 0]),
    (1, 2, 200, 260, 256, torch.bfloat16, True, None),
    (2, 2, 150, 130, 320, torch.float32, True, [130, 0]),
    (2, 2, 100, 100, 320, torch.bfloat16, False, [100, 60]),
    (1, 1, 70, 90, 520, torch.float32, False, None),
]


@pytest.mark.parametrize('case', FAULT_CASES)
def test_flash_kernels_take_every_input_of_the_default_path(cuda, case):
    """K2 and K3 against their plain versions (fp32: 1e-5 of the largest
    value; bf16: 1e-2 of it + 1e-2 relative), two backward runs bit-equal,
    the variant the launcher chose; a row with no live key gives the mean
    of V and lse -1e9 + log(Tk), and no gradient to q."""
    b, h, tq, tk, d, dtype, causal, lens = case
    gen = torch.Generator(device=cuda).manual_seed(31)
    q, do = (torch.randn(b, h, tq, d, generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    kv = None if lens is None else torch.tensor(lens, device=cuda)
    mma = dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
    before = (tfa.flash_fwd_cuda.launches_mma,
              tfa.flash_fwd_cuda.launches_simt)
    out, lse = tfa.flash_attention_fwd(q, k, v, kv, causal)
    moved = (tfa.flash_fwd_cuda.launches_mma - before[0],
             tfa.flash_fwd_cuda.launches_simt - before[1])
    assert moved == ((1, 0) if mma else (0, 1))
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, kv, causal)
    again = tfa.flash_attention_bwd(q, k, v, out, lse, do, kv, causal)
    torch.cuda.synchronize()
    for g, a in zip(grads, again):
        assert torch.equal(g, a)
    ref_out, ref_lse = tfa.flash_attention_reference_fwd(q, k, v, kv, causal)
    refs = tfa.flash_attention_reference_bwd(q, k, v, out, lse, do, kv,
                                             causal)
    for got, want in [(out, ref_out)] + list(zip(grads, refs)):
        got, want = got.float(), want.float()
        top = float(want.abs().max())
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5 * max(top, 1.0)
        else:
            assert bool(((got - want).abs() <=
                         1e-2 * top + 1e-2 * want.abs()).all())
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    live = tfa._live(tq, tk, kv, causal, cuda)
    dead = ~live.any(dim=-1).expand(b, h, tq)
    if bool(dead.any()):
        mean = v.float().mean(dim=2, keepdim=True).expand(b, h, tq, d)
        got = out.float()[dead]
        want = mean.to(dtype).float()[dead]
        assert bool(((got - want).abs() <= 1e-5 + 1e-2 *
                     want.abs() * (dtype == torch.bfloat16)).all())
        assert bool((lse[dead] == float(np.float32(-1e9 + np.log(tk)))).all())
        assert bool((grads[0][dead] == 0).all())


@pytest.mark.parametrize('case', [
    (torch.bfloat16, 36, 36, 0), (torch.float32, 30, 30, 0),
    (torch.float32, 64, 192, 0), (torch.bfloat16, 192, 192, 0),
    (torch.bfloat16, 256, 256, 0), (torch.bfloat16, 64, 64, 1),
    (torch.float32, 40, 18, 0), (torch.float32, 320, 320, 0),
    (torch.bfloat16, 320, 320, 0), (torch.float32, 64, 600, 0)])
def test_paged_attention_any_width_variant(cuda, case):
    """Rows the 16-byte kernel cannot load (no multiple of 16 bytes, wider
    than 512 bytes, Dv above 128, or an arena one element off 16-byte
    alignment) run on the any-width kernel, agree with both plain versions,
    and a row gives the same bits alone and inside its batch."""
    dtype, d, dv, shift = case
    lens = [1, 31, 32, 33, 300, 600, 2, 1]
    args = list(_paged_args(cuda, dtype, lens, nb=192, h=2, bs=32, d=d,
                            dv=dv, p=20, empty=(7,)))
    args[-1][7] = 0
    if shift:
        for i in (1, 2):
            flat = torch.empty(args[i].numel() + 1, dtype=dtype, device=cuda)
            view = flat[1:].view(args[i].shape)
            view.copy_(args[i])
            args[i] = view
    before = tpa.paged_attention.launches_any
    out = _paged_check(tuple(args), dtype)
    assert tpa.paged_attention.launches_any == before + 1
    q, kp, vp, tables, sl = args
    alone = tpa.paged_attention(q[4:5], kp, vp, tables[4:5], sl[4:5])
    torch.cuda.synchronize()
    assert torch.equal(alone[0], out[4])


def _grads_close(got, want, dtype):
    """dx: bf16 within one bf16 ulp of max(|kernel|, |plain|) plus 1e-6 of
    the largest |dx| (fp32 sums in another order where dx cancels), fp32
    max-norm relative 1e-5; parameter gradients max-norm relative 1e-5."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        top = float(w.abs().max())
        diff = (g - w).abs()
        if i == 0 and dtype == torch.bfloat16:
            ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
            assert bool((diff <= ulp + 1e-6 * top).all()), i
        else:
            assert float(diff.max()) <= 1e-5 * top, (i, float(diff.max()),
                                                     top)


def _bn_bwd_inputs(cuda, layout, shape, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = (1.0 + 2.0 * torch.randn(shape, generator=gen, device=cuda)).to(dtype)
    c = shape[1] if layout == 'NCHW' else shape[-1]
    s = 0.5 + torch.rand(c, generator=gen, device=cuda)
    b = torch.randn(c, generator=gen, device=cuda)
    gy = torch.randn(shape, generator=gen, device=cuda).to(dtype)

    def view(t):
        t4 = t.permute(0, 3, 1, 2) if layout == 'NHWC' else t
        return t4.reshape(t4.shape[0], c, -1) if t.dim() == 4 \
            else t.unsqueeze(-1)
    x3, g3 = view(x), view(gy)
    _, m, v = tbn._bn_cuda(x3, s, b, 1e-5)
    return x3, g3, s, m, v


@pytest.mark.parametrize('case', BN_CASES + BN_ONE_LAUNCH_CASES)
def test_batch_norm_backward_kernel_matches_plain_and_repeats(cuda, case):
    """The backward kernel against batch_norm_reference_bwd (_grads_close),
    one launch a call, no copy of a gradient already in x's layout, and
    the same bits twice."""
    layout, shape, dtype = case[:3]
    x3, g3, s, m, v = _bn_bwd_inputs(cuda, layout, shape, dtype, 41)
    before = (tbn.fused_batch_norm_train.bwd_launches,
              tbn.fused_batch_norm_train.bwd_gy_copies)
    got = tbn._bn_bwd_cuda(x3, g3, s, m, v, 1e-5)
    again = tbn._bn_bwd_cuda(x3, g3, s, m, v, 1e-5)
    torch.cuda.synchronize()
    assert (tbn.fused_batch_norm_train.bwd_launches,
            tbn.fused_batch_norm_train.bwd_gy_copies) == \
        (before[0] + 2, before[1])
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    assert got[0].stride() == x3.stride()
    _grads_close(got, tbn.batch_norm_reference_bwd(x3, g3, s, m, v, 1e-5),
                 dtype)


def test_batch_norm_backward_copies_a_gradient_of_another_layout(cuda):
    """A gradient in NCHW order for an NHWC activation is copied into x's
    layout once (counted), and the result is the same."""
    x3, g3, s, m, v = _bn_bwd_inputs(cuda, 'NHWC', (4, 6, 6, 32),
                                     torch.float32, 42)
    other = g3.contiguous()          # planes order, x3 is rows order
    assert other.stride() != x3.stride()
    before = tbn.fused_batch_norm_train.bwd_gy_copies
    got = tbn._bn_bwd_cuda(x3, other, s, m, v, 1e-5)
    assert tbn.fused_batch_norm_train.bwd_gy_copies == before + 1
    want = tbn._bn_bwd_cuda(x3, g3, s, m, v, 1e-5)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_batch_norm_backward_captures_into_a_graph(cuda):
    """The backward's cooperative launch records into a CUDA graph and the
    replay gives the eager bits."""
    x3, g3, s, m, v = _bn_bwd_inputs(cuda, 'NHWC', (64, 14, 14, 1024),
                                     torch.bfloat16, 43)
    want = tbn._bn_bwd_cuda(x3, g3, s, m, v, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tbn._bn_bwd_cuda(x3, g3, s, m, v, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tbn._bn_bwd_cuda(x3, g3, s, m, v, 1e-5)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('shape', [(4096, 512), (16, 512), (5, 100),
                                   (3, 2048), (7, 3000), (33, 1000)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_layer_norm_backward_kernels_match_plain_and_repeat(cuda, shape,
                                                            dtype):
    """Both backward kernels (row, column sum) against
    layer_norm_reference_bwd (_grads_close), two launches a call, the same
    bits twice, and autograd through fused_layer_norm launches them."""
    n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(44)
    x = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    g = 1.0 + 0.1 * torch.randn(d, generator=gen, device=cuda)
    b = 0.1 * torch.randn(d, generator=gen, device=cuda)
    gy = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    before = tln.fused_layer_norm.bwd_launches
    got = tln._ln_bwd_cuda(x, g, gy, 1e-5)
    again = tln._ln_bwd_cuda(x, g, gy, 1e-5)
    torch.cuda.synchronize()
    assert tln.fused_layer_norm.bwd_launches == before + 4
    for a, r in zip(got, again):
        assert torch.equal(a, r)
    _grads_close(got, tln.layer_norm_reference_bwd(x, g, b, gy, 1e-5), dtype)
    leaves = [t.clone().requires_grad_() for t in (x, g, b)]
    y = tln.fused_layer_norm(*leaves, eps=1e-5)
    auto = torch.autograd.grad(y, leaves, gy)
    assert tln.fused_layer_norm.bwd_launches == before + 6
    for a, r in zip(auto, got):
        assert torch.equal(a, r)


def _q8_args(cuda, kv_dtype, lens, d, h=2, bs=32, p=20, nb=192, seed=5,
             n_rows=None):
    """int8 or e4m3 pages quantized row by row, their scales, and the rest
    of _paged_args' inputs."""
    from paddle_tpu_torch.quant.core import quantize_rows
    q, kf, vf, tables, sl = _paged_args(cuda, torch.float32, lens, nb=nb,
                                        h=h, bs=bs, d=d, p=p, seed=seed)
    kq, ks = quantize_rows(kf * 3, kv_dtype)
    vq, vs = quantize_rows(vf, kv_dtype)
    return q, kq, vq, tables, sl, ks, vs


# (storage, d_key): 64 takes the 16-byte kernel, 8 and 36 the any-width one
@pytest.mark.parametrize('case', [('int8', 64), ('float8_e4m3fn', 64),
                                  ('int8', 8), ('float8_e4m3fn', 8),
                                  ('int8', 36), ('float8_e4m3fn', 320)])
def test_paged_attention_quantized_variant(cuda, case):
    """The quantized variant against its split plain version (the same
    dequantized operands, summed in another order: fp32 output within
    1e-5 of its largest value) and the one-pass plain version, twice for
    equal bits, counted by launches_q8 and the variant it took."""
    kv_dtype, d = case
    lens = [1, 31, 32, 33, 300, 600, 2, 0]
    q, kq, vq, tables, sl, ks, vs = _q8_args(cuda, kv_dtype, lens, d)
    tables[7] = kq.shape[0]
    kw = dict(k_scales=ks, v_scales=vs)
    before = dict(q8=tpa.paged_attention.launches_q8,
                  v16=tpa.paged_attention.launches_v16)
    out = tpa.paged_attention(q, kq, vq, tables, sl, **kw)
    again = tpa.paged_attention(q, kq, vq, tables, sl, **kw)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches_q8 == before['q8'] + 2
    assert tpa.paged_attention.launches_v16 - before['v16'] == \
        (2 if d == 64 else 0)
    assert torch.equal(out, again)
    assert bool((out[7] == 0).all())            # the empty slot
    for ref in (tpa.paged_attention_split_reference(q, kq, vq, tables, sl,
                                                    **kw),
                tpa.paged_attention_reference(q, kq, vq, tables, sl,
                                              **kw)):
        top = float(ref[:7].abs().max())
        assert float((out[:7] - ref[:7]).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize('kv_dtype', ['int8', 'float8_e4m3fn'])
def test_paged_attention_quantized_rows_do_not_depend_on_the_batch(
        cuda, kv_dtype):
    """A row of a 16-row decode batch gives the same bits alone and as
    one row of a 64-row verify call (16 sequences x k+1 = 4 rows, the
    tables repeated per row)."""
    lens = [1, 40, 300, 512, 257, 256, 64, 31] * 2
    q, kq, vq, tables, sl, ks, vs = _q8_args(cuda, kv_dtype, lens, 64,
                                             h=4, p=16, nb=512)
    kw = dict(k_scales=ks, v_scales=vs)
    full = tpa.paged_attention(q, kq, vq, tables, sl, **kw)
    rep = tables.repeat_interleave(4, dim=0)
    for i in (1, 2, 3, 4):
        alone = tpa.paged_attention(q[i:i + 1], kq, vq, tables[i:i + 1],
                                    sl[i:i + 1], **kw)
        qs = torch.randn(64, *q.shape[1:], device=cuda)
        ls = (sl.repeat_interleave(4) +
              torch.arange(4, device=cuda, dtype=torch.int32).repeat(16))
        ls = ls.clamp(max=512).to(torch.int32)
        qs[4 * i], ls[4 * i] = q[i], sl[i]
        many = tpa.paged_attention(qs, kq, vq, rep, ls, **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone[0], full[i])
        assert torch.equal(many[4 * i], full[i])


def test_paged_attention_quantized_wrapper_wants_its_scales(cuda):
    q, kq, vq, tables, sl, ks, vs = _q8_args(cuda, 'int8', [5, 9], 64)
    before = tpa.paged_attention.launches
    with pytest.raises(ValueError, match='scales'):
        tpa.paged_attention(q, kq, vq, tables, sl)           # no scales
    with pytest.raises(ValueError, match='scales'):
        tpa.paged_attention(q, kq.float(), vq.float(), tables, sl,
                            k_scales=ks, v_scales=vs)       # fp32 pages
    with pytest.raises(ValueError, match='scales'):
        tpa.paged_attention(q, kq, vq, tables, sl, k_scales=ks[:, :1],
                            v_scales=vs)
    assert tpa.paged_attention.launches == before


def test_engine_extras_on_card_equal_host(cuda):
    """Prefix cache, spec_k=2 and int8 arenas together: the card's greedy
    streams equal the host's, and the pool drains on both."""
    spec = LMSpec(vocab_size=64, n_layer=2, n_head=2, d_key=16, d_value=16,
                  d_model=32, d_inner=64)
    geom = dict(max_batch=4, block_size=8, num_blocks=32, pages_per_seq=4)
    weights = random_weights(spec, seed=2)
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 64, 12).tolist()
    prompts = [shared + rng.randint(0, 64, int(rng.randint(1, 6))).tolist()
               for _ in range(6)]
    out = {}
    for place in (pt.CUDAPlace(0), pt.CPUPlace()):
        eng = DecodeEngine(spec, place=place, weights=weights,
                           prefix_cache=True, spec_k=2, kv_dtype='int8',
                           **geom)
        eng.start()
        streams = [eng.submit(pr, max_new_tokens=8) for pr in prompts]
        out[type(place).__name__] = [s.result(timeout=120)
                                     for s in streams]
        eng.shutdown()
        assert eng.free_pages() == eng.num_blocks
    assert out['CUDAPlace'] == out['CPUPlace']


# ---- the KV write: the stand-alone kernel, and the write folded into K4's
# launch


@pytest.mark.parametrize('src', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kv_dtype', ['float32', 'bfloat16', 'int8',
                                      'float8_e4m3fn'])
def test_kv_write_kernel_matches_plain(cuda, kv_dtype, src):
    """The KV-write kernel against its plain version (quantize_rows and
    the masked scatter) bit for bit, arenas and scales: kept rows written
    (an all-zero row among them), dropped rows (one through an entry past
    the pool) leave everything as it was."""
    from paddle_tpu_torch.ops.kernels import kv_write as tkw
    gen = torch.Generator(device=cuda).manual_seed(41)
    nb, h, bs, d, dv, n = 12, 3, 8, 40, 24, 10
    k_new = (3 * torch.randn(n, h, d, generator=gen, device=cuda)).to(src)
    v_new = torch.randn(n, h, dv, generator=gen, device=cuda).to(src)
    k_new[2] = 0
    slots = torch.randperm(nb * bs, generator=gen, device=cuda)[:n]
    phys = (slots // bs).to(torch.int32)
    off = (slots % bs).to(torch.int32)
    keep = torch.rand(n, generator=gen, device=cuda) < 0.7
    keep[2] = True
    phys[5] = nb
    keep[5] = False
    dtype = getattr(torch, kv_dtype)
    quant = kv_dtype in ('int8', 'float8_e4m3fn')

    def arena(width):
        raw = torch.randint(0, 255, (nb, h, bs, width), generator=gen,
                            device=cuda, dtype=torch.uint8)
        return raw.view(dtype) if quant else raw.to(dtype)

    ka, va = arena(d), arena(dv)
    scales = [torch.randn(nb, h, bs, generator=gen, device=cuda)
              for _ in range(2)] if quant else [None, None]
    outs = []
    for fn in (tkw.kv_write_reference, tkw.kv_write):
        bufs = [ka.clone(), va.clone()] + \
            [x.clone() if x is not None else None for x in scales]
        before = tkw.kv_write.launches
        fn(k_new, v_new, bufs[0], bufs[1], phys, off, keep, bufs[2],
           bufs[3])
        assert tkw.kv_write.launches == before + (fn is tkw.kv_write)
        outs.append(bufs)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        if a is None:
            continue
        if a.element_size() == 1:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a, b)
    dropped = ~keep
    for i in torch.nonzero(dropped[:5])[:, 0].tolist():
        p, o = int(phys[i]), int(off[i])
        assert torch.equal(outs[1][0].view(torch.uint8)[p, :, o]
                           if quant else outs[1][0][p, :, o],
                           ka.view(torch.uint8)[p, :, o]
                           if quant else ka[p, :, o])


# the arenas the fold takes, each with new rows of its own dtype
WRITE_KV = ['float32', 'bfloat16']
# (D, Dv) of each split variant: the 16-byte kernel, the any-width kernel
# (rows of 30 elements fit no 16-byte load) and the any-width kernel with
# two 256-column value chunks (a split taken by two blocks)
WRITE_VARIANTS = {'v16': (64, 64), 'any': (30, 30), 'any_dv320': (64, 320)}


def _write_rows(kind, nb, bs, p, gen, cuda):
    """A row set of the decode ops on the card, with rows that drop:
    (tables, pos, live, fresh_lo, fresh_src) as the ops make them."""
    perm = torch.randperm(nb, generator=gen, device=cuda).to(torch.int32)
    cap = p * bs

    def own(lens_top):
        tables = perm[:len(lens_top) * p].reshape(len(lens_top), p).clone()
        for i, top in enumerate(lens_top):
            tables[i, -(-(top + 1) // bs):] = nb + 3
        return tables
    if kind == 'decode':
        # an empty slot (length 0, every entry >= NB), lengths at page and
        # 256-token chunk edges, and one row at the table's capacity
        lens = [0, 1, 15, 16, 17, 255, 256, 257, 511, cap]
        tables = own([min(x, cap - 1) for x in lens])
        tables[0] = nb
        pos = torch.tensor(lens, dtype=torch.int32, device=cuda)
        rows = torch.arange(len(lens), dtype=torch.int32, device=cuda)
        return tables, pos, torch.ones_like(pos, dtype=torch.bool), pos, rows
    if kind == 'verify':
        k1, lens = 4, [3, 254, cap - 3, 0]   # the third's last row drops
        tables = own([min(x + k1 - 1, cap - 1) for x in lens])
        tables[3] = nb
        rep = torch.arange(len(lens), device=cuda).repeat_interleave(k1)
        base = torch.tensor(lens, dtype=torch.int32, device=cuda)[rep]
        pos = base + torch.arange(k1, dtype=torch.int32,
                                  device=cuda).repeat(len(lens))
        return (tables[rep].contiguous(), pos,
                torch.ones_like(pos, dtype=torch.bool), base,
                (rep * k1).to(torch.int32))
    # prefill: 64 padded rows after 230 cached tokens (across the first
    # chunk's end), Len 50, one broadcast table row
    s, cached, length = 64, 230, 50
    row = own([cached + s - 1])[0]
    t = torch.arange(s, dtype=torch.int32, device=cuda)
    return (row.expand(s, p), cached + t, t < length,
            torch.full_like(t, cached), torch.zeros_like(t))


def _write_case(cuda, kind, kv_dtype, src, d, dv, seed, h=4, nb=320, bs=16,
                p=32):
    """Inputs of the fused launch for a row set (`kind`, or the tuple of
    `_write_rows`): random arenas (quantized row by row), new rows with an
    all-zero one, the write slots, and `ok`, the rows that read only kept
    rows."""
    from paddle_tpu_torch.ops.paged_decode_ops import write_slots
    from paddle_tpu_torch.quant.core import kv_quantized, quantize_rows
    src = getattr(torch, kv_dtype) if src is None else src
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rows = _write_rows(kind, nb, bs, p, gen, cuda) \
        if isinstance(kind, str) else kind
    tables, pos, live, fresh_lo, fresh_src = rows
    n = pos.shape[0]
    kf = torch.randn(nb, h, bs, d, generator=gen, device=cuda)
    vf = torch.randn(nb, h, bs, dv, generator=gen, device=cuda)
    t = dict(q=torch.randn(n, h, d, generator=gen, device=cuda),
             k_new=(3 * torch.randn(n, h, d, generator=gen,
                                    device=cuda)).to(src),
             v_new=torch.randn(n, h, dv, generator=gen, device=cuda).to(src),
             tables=tables, lens=pos + 1, fresh_lo=fresh_lo,
             fresh_src=fresh_src)
    t['k_new'][1, 0] = 0                  # an all-zero row: scale 1e-30/q
    if kv_quantized(kv_dtype):
        t['kp'], t['ks'] = quantize_rows(kf, kv_dtype)
        t['vp'], t['vs'] = quantize_rows(vf, kv_dtype)
    else:
        dt = getattr(torch, kv_dtype)
        t['kp'], t['vp'], t['ks'], t['vs'] = kf.to(dt), vf.to(dt), None, None
    t['phys'], t['off'], t['keep'] = write_slots(tables, pos, live, nb, bs)
    keep = t['keep'].tolist()
    lo, src_rows, top = fresh_lo.tolist(), fresh_src.tolist(), pos.tolist()
    t['ok'] = torch.tensor(
        [keep[r] and all(keep[src_rows[r] + x - lo[r]]
                         for x in range(lo[r], min(top[r] + 1, p * bs)))
         for r in range(n)], device=cuda)
    return t


def _write_arenas(t):
    return [x.clone() if x is not None else None
            for x in (t['kp'], t['vp'], t['ks'], t['vs'])]


def _write_args(t, arenas):
    kp, vp = arenas[:2]
    return (t['q'], t['k_new'], t['v_new'], kp, vp, t['tables'], t['lens'],
            t['phys'], t['off'], t['keep'], t['fresh_lo'], t['fresh_src'])


def _raw8(x):
    return x.view(torch.uint8) if x.element_size() == 1 else x


def _check_write(t, kv_dtype):
    """The fused launch against its plain versions: the arenas bit for bit
    with kv_write_reference; the rows that read only kept rows bit for bit
    with the unfused K4 kernel run after that write, and within K4's
    tolerances of the kernel-order plain version. Returns the counter
    deltas of the fused call: (launches, wrote, 16-byte, any-width,
    quantized)."""
    want = _write_arenas(t)
    tpa.kv_write_reference(t['k_new'], t['v_new'], want[0], want[1],
                           t['phys'], t['off'], t['keep'])
    unfused = tpa.paged_attention(t['q'], want[0], want[1], t['tables'],
                                  t['lens'])
    got = _write_arenas(t)
    f = tpa.paged_attention

    def counts():
        return (f.launches, f.launches_write, f.launches_v16,
                f.launches_any, f.launches_q8)
    before = counts()
    out = tpa.paged_attention_write(*_write_args(t, got))
    moved = tuple(a - b for a, b in zip(counts(), before))
    plain = tpa.paged_attention_write_split_reference(
        *_write_args(t, _write_arenas(t)))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if a is not None:
            assert torch.equal(_raw8(a), _raw8(b))
    ok = t['ok']
    assert ok.any() and not ok.all()
    assert torch.equal(out[ok], unfused[ok])
    gap = (out[ok] - plain[ok]).abs()
    if kv_dtype == 'float32':
        assert float(gap.max()) <= 5e-5
    else:
        assert bool((gap <= 2e-2 + 2e-2 * plain[ok].abs()).all())
    return moved


@pytest.mark.parametrize('variant', sorted(WRITE_VARIANTS))
@pytest.mark.parametrize('kind', ['decode', 'verify', 'prefill'])
@pytest.mark.parametrize('kv_dtype', WRITE_KV)
def test_paged_attention_write_kernel_matches_plain(cuda, kv_dtype, kind,
                                                    variant):
    """The KV write folded into K4's split launch, both split variants,
    fp32 and bf16 arenas under new rows of their dtype, the decode, verify
    (k + 1 = 4) and broadcast prefill row sets with dropped rows: arenas
    bit for bit with the plain write, kept rows bit for bit with write-
    then-attend through the unfused kernel; one launch that wrote, on the
    variant the shape asks for."""
    d, dv = WRITE_VARIANTS[variant]
    t = _write_case(cuda, kind, kv_dtype, None, d, dv,
                    seed=100 * WRITE_KV.index(kv_dtype) + 10 * len(kind) +
                    len(variant))
    launches, wrote, v16, any_, q8 = _check_write(t, kv_dtype)
    assert (launches, wrote, q8) == (1, 1, 0)
    assert (v16, any_) == ((1, 0) if variant == 'v16' else (0, 1))


@pytest.mark.parametrize('kv_dtype', WRITE_KV)
def test_paged_attention_write_prefill_512_rows(cuda, kv_dtype):
    """The prefill's 512 broadcast rows at the decode configuration's
    width (8 heads, head dim 64, pages of 32), nothing cached, so every
    key a row reads comes from the input; Len 500, so the last 12 rows
    drop: the same checks."""
    s, nb, bs, p = 512, 128, 32, 64
    row = torch.randperm(nb, device=cuda)[:p].to(torch.int32)
    row[s // bs:] = nb + 3
    pos = torch.arange(s, dtype=torch.int32, device=cuda)
    rows = (row.expand(s, p), pos, pos < 500, torch.zeros_like(pos),
            torch.zeros_like(pos))
    t = _write_case(cuda, rows, kv_dtype, None, 64, 64, seed=9, h=8, nb=nb,
                    bs=bs, p=p)
    assert _check_write(t, kv_dtype)[:2] == (1, 1)


@pytest.mark.parametrize('kv_dtype', WRITE_KV)
def test_paged_attention_write_captured(cuda, kv_dtype):
    """The fused launch captured in a CUDA graph and replayed: the output
    and the arenas equal the eager call's, bit for bit, and each replay
    counts nothing on the host (the executor adds a graph's recorded
    launches itself)."""
    t = _write_case(cuda, 'verify', kv_dtype, None, 64, 64, seed=12)
    eager_arenas = _write_arenas(t)
    eager = tpa.paged_attention_write(*_write_args(t, eager_arenas))
    arenas = _write_arenas(t)
    args = _write_args(t, arenas)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_attention_write(*args)
    torch.cuda.current_stream().wait_stream(side)
    for a, b in zip(arenas, _write_arenas(t)):   # back to the old arenas
        if a is not None:
            a.copy_(b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_attention_write(*args)
    before = tpa.paged_attention.launches_write
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches_write == before
    assert torch.equal(out, eager)
    for a, b in zip(arenas, eager_arenas):
        if a is not None:
            assert torch.equal(_raw8(a), _raw8(b))


def test_paged_attention_write_wrapper_rejects_bad_inputs(cuda):
    """The fused wrapper names what it needs: new rows of the arena's
    head count, width and dtype (fp32 or bf16 arenas; a write that
    converts is kv_write's), int32 vectors of one length, a bool keep,
    every tensor on the card."""
    t = _write_case(cuda, 'decode', 'float32', None, 64, 64, seed=13)
    q8 = _write_case(cuda, 'decode', 'int8', torch.float32, 64, 64, seed=13)

    def call(**swap):
        u = dict(t, **swap)
        return tpa.paged_attention_write(*_write_args(u, _write_arenas(u)))
    call()
    for bad in (dict(k_new=t['k_new'][:, :, :32].contiguous()),
                dict(v_new=t['v_new'].half()),
                dict(k_new=t['k_new'].half(), v_new=t['v_new'].half()),
                dict(k_new=t['k_new'].bfloat16(),
                     v_new=t['v_new'].bfloat16()),
                dict(kp=t['kp'].bfloat16(), vp=t['vp'].bfloat16()),
                dict(kp=q8['kp'], vp=q8['vp']),
                dict(phys=t['phys'].long()),
                dict(keep=t['keep'].to(torch.int32)),
                dict(fresh_lo=t['fresh_lo'][:3]),
                dict(fresh_src=t['fresh_src'].cpu())):
        with pytest.raises(ValueError):
            call(**bad)


# ---- the captured step: keep mask and the executor's graphs


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.bool])
def test_keep_mask_kernel_matches_plain(cuda, dtype):
    """The keep-mask kernel gives the plain version's bits, at a shape
    with a ragged tail and at the Transformer's FFN shape (where about
    keep of the elements are kept), for two steps that differ."""
    from paddle_tpu_torch.ops.kernels import random_bits as rb
    for shape in [(3, 5, 7), (64, 64, 2048)]:
        masks = []
        for step in (0, 5):
            st = torch.tensor(step, dtype=torch.int64, device=cuda)
            before = rb.keep_mask.launches
            got = rb.keep_mask(shape, 0.9, 12345, st, cuda, dtype)
            assert rb.keep_mask.launches == before + 1
            want = rb.keep_mask_reference(shape, 0.9, 12345, st, cuda,
                                          dtype)
            assert got.dtype == dtype and torch.equal(got, want)
            masks.append(got)
        assert not torch.equal(masks[0], masks[1])
        if len(shape) == 3 and shape[-1] == 2048:
            share = float(masks[0].float().mean())
            assert abs(share - 0.9) < 1e-3


def _raw_bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int16)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mode', ['mul', 'mul_div', 'where_div'])
def test_dropout_kernel_matches_plain(cuda, mode, dtype):
    """The fused dropout kernel against its plain version on the card
    (torch's own expression, its keep bits from keep_bits_reference), bit
    for bit forward and backward, at the Transformer's dropout shapes, a
    ragged size and a copy one element into its storage (not 16-byte
    aligned: the scalar path), with ±0, ±inf and NaN among the inputs, at
    two steps; each call one launch of its direction, no mask written."""
    from paddle_tpu_torch.ops.kernels import random_bits as rb
    gen = torch.Generator(device=cuda).manual_seed(3)
    special = torch.tensor([0.0, -0.0, float('inf'), -float('inf'),
                            float('nan'), 1e-30, -3.5], device=cuda)
    for shape in [(64, 64, 2048), (64, 64, 512), (3, 5, 7)]:
        n = int(np.prod(shape))
        for step_value in (0, 9):
            step = torch.tensor(step_value, dtype=torch.int64, device=cuda)
            x = torch.randn(n, generator=gen, device=cuda)
            x[:7] = special
            x = x.to(dtype).reshape(shape)
            for backward in (False, True):
                before = (rb.fused_dropout.launches,
                          rb.fused_dropout.bwd_launches,
                          rb.keep_mask.launches)
                got = rb.fused_dropout(x, mode, 0.9, 0x2468ace, step,
                                       backward=backward)
                assert (rb.fused_dropout.launches,
                        rb.fused_dropout.bwd_launches,
                        rb.keep_mask.launches) == (
                    before[0] + (not backward), before[1] + backward,
                    before[2])
                want = rb.dropout_reference(x, mode, 0.9, 0x2468ace, step,
                                            backward=backward)
                assert got.dtype == dtype and got.shape == x.shape
                assert torch.equal(_raw_bits(got), _raw_bits(want)), \
                    (shape, step_value, backward)
        buf = torch.randn(n + 1, generator=gen, device=cuda).to(dtype)
        odd = buf[1:].view(shape)
        assert odd.data_ptr() % 16 != 0
        for backward in (False, True):
            got = rb.fused_dropout(odd, mode, 0.9, 5, step, backward)
            want = rb.dropout_reference(odd, mode, 0.9, 5, step, backward)
            assert torch.equal(_raw_bits(got), _raw_bits(want))
    with pytest.raises(TypeError):
        rb.fused_dropout(x.half(), mode, 0.9, 1, step)
    with pytest.raises(TypeError):
        rb.fused_dropout(x.transpose(0, 1), mode, 0.9, 1, step)


def test_dropout_kernel_captured_equals_eager(cuda):
    """The fused dropout launched inside a CUDA graph reads the step on
    the device: each replay after a step change equals an eager launch at
    that step, forward and backward, bf16."""
    from paddle_tpu_torch.ops.kernels import random_bits as rb
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(64, 64, 512, generator=gen, device=cuda).to(
        torch.bfloat16)
    step = torch.tensor(0, dtype=torch.int64, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rb.fused_dropout(x, 'mul_div', 0.9, 77, step)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fwd = rb.fused_dropout(x, 'mul_div', 0.9, 77, step)
        bwd = rb.fused_dropout(x, 'mul_div', 0.9, 77, step, backward=True)
    outs = []
    for s in (3, 4):
        step.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(fwd, rb.fused_dropout(x, 'mul_div', 0.9, 77,
                                                 step))
        assert torch.equal(bwd, rb.fused_dropout(x, 'mul_div', 0.9, 77, step,
                                                 backward=True))
        outs.append(fwd.clone())
    assert not torch.equal(outs[0], outs[1])


def test_dropout_training_on_card_equals_host(cuda):
    """A 2-layer Transformer at fp32 and dropout 0.1, 3 Adam steps from
    the same weights on the card and on the host: the same keep bits on
    both (losses to 1e-5 relative, parameters within Adam's
    2·lr·steps, as at dropout 0); the card's steps ran the fused dropout
    (forward and backward, 2 · 4 + 2 · 6 + 2 sites a step) and drew no
    mask."""
    from paddle_tpu_torch.ops.kernels import random_bits as rb
    from paddle_tpu_torch.weights import load_into_scope
    avg_cost, feed = _small_transformer(0.1)
    main = pt.default_main_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    losses, scopes = [], []
    for place in (pt.CUDAPlace(0), pt.CPUPlace()):
        scope = pt.Scope()
        load_into_scope(weights, scope, place)
        before = (rb.fused_dropout.launches, rb.fused_dropout.bwd_launches,
                  rb.keep_mask.launches)
        with pt.scope_guard(scope):
            exe = pt.Executor(place)
            losses.append([float(exe.run(main, feed=feed,
                                         fetch_list=[avg_cost])[0])
                           for _ in range(3)])
        if isinstance(place, pt.CUDAPlace):
            sites = 2 * 4 + 2 * 6 + 2
            assert (rb.fused_dropout.launches - before[0],
                    rb.fused_dropout.bwd_launches - before[1],
                    rb.keep_mask.launches - before[2]) == (
                3 * sites, 3 * sites, 0)
        scopes.append(scope)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for p in main.all_parameters():
        if p.trainable:
            gap = np.abs(scopes[0].numpy(p.name) - scopes[1].numpy(p.name))
            assert gap.max() <= 2 * 1e-3 * 3, p.name


def _snapshot(scope):
    return {n: scope.find(n).detach().clone() for n in scope.keys()}


def _restore(scope, snap):
    """Every scope tensor takes its snapshot in place (the captured graphs
    stay valid)."""
    for n, t in snap.items():
        scope.find(n).copy_(t)


def _small_transformer(dropout, scan_layers=False):
    from paddle_tpu_torch.models import transformer as T
    pt.reset_default_programs()
    avg_cost, _ = T.transformer_base(
        src_vocab_size=96, trg_vocab_size=96, src_seq_len=24,
        trg_seq_len=24, n_layer=2, n_head=4, d_key=16, d_value=16,
        d_model=64, d_inner=128, dropout_rate=dropout,
        scan_layers=scan_layers)
    pt.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return avg_cost, T.make_fake_batch(3, 24, 24, 96, 96, seed=2)


def _three_ways(cuda, avg_cost, feed, steps=3):
    """The same ``steps`` training steps from the same state three ways:
    replays of a captured graph, eager runs (use_program_cache=False) and
    one run_steps call. Each executor first runs two steps (the eager
    warm-up and the capture) and then takes its state back, so all three
    draw the dropout masks of steps 2, 3, 4. Returns {mode: (losses,
    {var: numpy})}."""
    from paddle_tpu_torch.weights import load_into_scope
    main = pt.default_main_program()
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(pt.default_startup_program())
    weights = {n: host.numpy(n) for n in host.keys()}
    res = {}
    for mode in ('captured', 'eager', 'run_steps'):
        scope = pt.Scope()
        load_into_scope(weights, scope, pt.CUDAPlace(0))
        exe = pt.Executor(pt.CUDAPlace(0))
        cache = mode != 'eager'
        snap = _snapshot(scope)
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[avg_cost],
                        use_program_cache=cache)
            _restore(scope, snap)
            ptrs = {n: scope.find(n).data_ptr() for n in scope.keys()}
            if mode == 'run_steps':
                losses = exe.run_steps(steps, main, feed=feed,
                                       fetch_list=[avg_cost])[0].reshape(-1)
            else:
                losses = np.array([
                    exe.run(main, feed=feed, fetch_list=[avg_cost],
                            use_program_cache=cache)[0].reshape(())
                    for _ in range(steps)])
            assert exe.last_captured == cache
            assert exe.captures == (1 if cache else 0)
        assert ptrs == {n: scope.find(n).data_ptr() for n in scope.keys()}
        res[mode] = (losses, {n: scope.numpy(n) for n in scope.keys()})
    return res


def test_captured_training_equals_eager_bit_for_bit(cuda):
    """A small Transformer at fp32 with dropout 0.1: three captured steps
    equal three eager steps, and run_steps(3) equals three run calls, bit
    for bit in the losses and every scope variable (parameters, Adam
    moments, beta powers); every scope tensor keeps its address."""
    avg_cost, feed = _small_transformer(0.1)
    res = _three_ways(cuda, avg_cost, feed)
    base_losses, base_vars = res['captured']
    assert np.isfinite(base_losses).all()
    for mode in ('eager', 'run_steps'):
        losses, vars_ = res[mode]
        np.testing.assert_array_equal(losses, base_losses, err_msg=mode)
        for n, v in base_vars.items():
            np.testing.assert_array_equal(vars_[n], v, err_msg=n)


def test_captured_resnet_step_matches_eager(cuda):
    """A small bottleneck ResNet (fp32, NHWC, Momentum): captured steps
    against eager ones from the same state, losses and every scope
    variable (running statistics among them) within 1e-6 relative of
    their largest entry (cuDNN's backward need not repeat its bits)."""
    from paddle_tpu_torch.models import resnet as R
    pt.reset_default_programs()
    img = pt.layers.data(name='image', shape=[3, 16, 16], dtype='float32')
    label = pt.layers.data(name='label', shape=[1], dtype='int64')
    h = pt.layers.transpose(img, [0, 2, 3, 1])
    h = R.conv_bn_layer(h, 16, 3, 1, 1, data_format='NHWC')
    h = R.layer_warp(R.bottleneck, h, 8, 2, 2, data_format='NHWC')
    h = pt.layers.pool2d(h, pool_type='avg', global_pooling=True,
                         data_format='NHWC')
    avg = pt.layers.mean(pt.layers.cross_entropy(
        pt.layers.fc(h, size=10, act='softmax'), label))
    pt.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(avg)
    res = _three_ways(cuda, avg, R.make_fake_batch(8, 16, 10, seed=3),
                      steps=2)
    base_losses, base_vars = res['eager']
    for mode in ('captured', 'run_steps'):
        losses, vars_ = res[mode]
        np.testing.assert_allclose(losses, base_losses, rtol=1e-6)
        for n, v in base_vars.items():
            top = max(float(np.abs(v).max()), 1e-30)
            assert float(np.abs(vars_[n] - v).max()) <= 1e-6 * top, n


def test_startup_program_is_host_bound_and_never_captured(cuda):
    """A startup program draws on the host: it runs eagerly every time;
    the main program's second call is a replay."""
    avg_cost, feed = _small_transformer(0.0)
    exe = pt.Executor(pt.CUDAPlace(0))
    with pt.scope_guard(pt.Scope()):
        for _ in range(3):
            exe.run(pt.default_startup_program())
            assert not exe.last_captured
        assert exe.captures == 0
        exe.run(feed=feed, fetch_list=[avg_cost])
        assert not exe.last_captured and exe.last_cache_miss
        exe.run(feed=feed, fetch_list=[avg_cost])
        assert exe.last_captured and exe.last_cache_miss
        h = exe.run(feed=feed, fetch_list=[avg_cost], return_handle=True)
        assert exe.last_captured and not exe.last_cache_miss
        assert h.steps == 1 and not h.cache_miss
        first = h.resolve()
        assert h.ready() and h.resolve() is first
        assert np.isfinite(first[0]).all()


def _eager_engine(eng):
    """Run an engine's programs eagerly (use_program_cache=False)."""
    import functools
    eng._exe.run = functools.partial(type(eng._exe).run, eng._exe,
                                     use_program_cache=False)
    return eng


def test_captured_engine_streams_equal_eager_and_capture_once(cuda):
    """The engine with prefix cache and spec_k=2 at int8 arenas: warm-up
    captures each shape once and serving captures nothing; greedy and
    sampled streams equal an eager engine's; a tensor that scope.set
    installs is captured again (load_weights copies and is not)."""
    spec = LMSpec(vocab_size=64, n_layer=2, n_head=2, d_key=16, d_value=16,
                  d_model=32, d_inner=64)
    geom = dict(max_batch=4, block_size=8, num_blocks=48, pages_per_seq=4,
                prefix_cache=True, spec_k=2, kv_dtype='int8')
    weights = random_weights(spec, seed=2)
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 64, 12).tolist()
    prompts = [shared + rng.randint(0, 64, int(rng.randint(1, 6))).tolist()
               for _ in range(6)]
    temps = [0.0, 0.0, 0.7, 0.0, 0.9, 0.0]

    def serve(eng):
        eng.start()
        streams = [eng.submit(pr, max_new_tokens=8, temperature=t, seed=i)
                   for i, (pr, t) in enumerate(zip(prompts, temps))]
        return [s.result(timeout=120) for s in streams]

    eager = _eager_engine(DecodeEngine(spec, place=pt.CUDAPlace(0),
                                       weights=weights, **geom))
    eager.warmup()
    want = serve(eager)
    eager.shutdown()
    assert eager.captures == 0

    eng = DecodeEngine(spec, place=pt.CUDAPlace(0), weights=weights, **geom)
    shapes = eng.warmup()
    assert eng.captures == shapes
    mb, pps = eng.max_batch, eng.pages_per_seq
    eng._run_decode(np.zeros((mb,), 'int64'), np.zeros((mb,), 'int32'),
                    np.full((mb, pps), eng.num_blocks, 'int32'),
                    np.zeros((mb,), 'float32'), np.zeros((mb,), 'int32'))
    assert eng._exe.last_captured
    got = serve(eng)
    assert eng.captures == shapes
    assert got == want
    eng.load_weights(weights)
    assert eng.captures == shapes
    name = eng._progs.param_names[0]
    eng._scope.set(name, eng._scope.find(name).clone())
    again = eng.generate(prompts[0], max_new_tokens=8, timeout=120)
    assert eng.captures > shapes
    assert again == want[0]
    eng.shutdown()
    assert eng.free_pages() == eng.num_blocks


# ---- NMT inference, the stacked Transformer and top_k's ties

NMT = dict(n_layer=2, n_head=4, d_key=16, d_value=16, d_model=64,
           d_inner=128)
NMT_VOCAB, NMT_SRC, NMT_BEAM = 96, 12, 3


def _nmt_weights():
    """The port's startup of the unrolled inference graph's parameters,
    drawn on the host."""
    from paddle_tpu_torch.models import transformer as T
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        T.transformer_greedy_infer(NMT_VOCAB, NMT_VOCAB, max_out_len=2,
                                   src_seq_len=NMT_SRC, **NMT)
    host = pt.Scope()
    with pt.scope_guard(host):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {n: host.numpy(n) for n in host.keys()}


def _nmt_program(kind, incremental, t_out=9):
    from paddle_tpu_torch.models import transformer as T
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        kw = dict(max_out_len=t_out, src_seq_len=NMT_SRC,
                  incremental=incremental, **NMT)
        if kind == 'greedy':
            fetch = [T.transformer_greedy_infer(NMT_VOCAB, NMT_VOCAB,
                                                **kw)[0]]
        else:
            fetch = list(T.transformer_beam_infer(
                NMT_VOCAB, NMT_VOCAB, beam_size=NMT_BEAM, **kw)[0])
    return main, fetch


def _nmt_scope(weights, place):
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.weights import load_into_scope
    scope = pt.Scope()
    load_into_scope(weights, scope, place)
    T.stack_trained_weights(scope, NMT['n_layer'])
    return scope


def _nmt_feed(seed=0, batch=5):
    rng = np.random.RandomState(seed)
    return {'src_word': rng.randint(2, NMT_VOCAB, (batch, NMT_SRC))
            .astype('int64'),
            'src_length': rng.randint(3, NMT_SRC + 1, batch).astype('int64')}


@pytest.mark.parametrize('incremental', [False, True])
@pytest.mark.parametrize('kind', ['greedy', 'beam'])
def test_nmt_decode_on_card_equals_host(cuda, kind, incremental):
    """Greedy and beam (fp32) on the card equal the host: the same ids,
    beam scores within 1e-4 relative. The card's replay equals its eager
    run bit for bit, and launches K2 and K1 exactly as many times as the
    code says."""
    weights = _nmt_weights()
    feed = _nmt_feed()
    prog, fetch = _nmt_program(kind, incremental)
    out = {}
    for place in (pt.CUDAPlace(0), pt.CPUPlace()):
        scope = _nmt_scope(weights, place)
        exe = pt.Executor(place)
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(prog, feed=feed, fetch_list=fetch)
            fa, ln = tfa.flash_fwd_cuda.launches, tln.fused_layer_norm.launches
            out[type(place).__name__] = exe.run(prog, feed=feed,
                                                fetch_list=fetch)
            launched = (tfa.flash_fwd_cuda.launches - fa,
                        tln.fused_layer_norm.launches - ln)
            if isinstance(place, pt.CUDAPlace):
                assert exe.last_captured
                eager = exe.run(prog, feed=feed, fetch_list=fetch,
                                use_program_cache=False)
                for a, b in zip(out['CUDAPlace'], eager):
                    np.testing.assert_array_equal(a, b)
                layers, t = NMT['n_layer'], 9
                assert launched == (
                    layers + (0 if incremental else 2 * layers * (t - 1)),
                    2 * layers + 3 * layers * (t - 1))
    card, host = out['CUDAPlace'], out['CPUPlace']
    np.testing.assert_array_equal(card[0], host[0])
    if kind == 'beam':
        np.testing.assert_allclose(card[1], host[1], rtol=1e-4)


def test_nmt_recaptures_after_stack_trained_weights(cuda):
    """A second stack_trained_weights installs new tensors: the next call
    captures its graph again (the replay's address check) and reads
    them."""
    from paddle_tpu_torch.models import transformer as T
    weights = _nmt_weights()
    feed = _nmt_feed()
    prog, fetch = _nmt_program('greedy', True)
    scope = _nmt_scope(weights, pt.CUDAPlace(0))
    exe = pt.Executor(pt.CUDAPlace(0))
    with pt.scope_guard(scope):
        runs = [exe.run(prog, feed=feed, fetch_list=fetch)[0]
                for _ in range(3)]
        assert exe.captures == 1 and not exe.last_cache_miss
        T.stack_trained_weights(scope, NMT['n_layer'])
        again = exe.run(prog, feed=feed, fetch_list=fetch)[0]
        assert exe.last_cache_miss and exe.last_captured
        assert exe.captures == 2
        # the new tensors are what the graph reads: zeroing the output
        # projection's stacked FFN changes the ids
        scope.find('dec_stack_ffn_2.w').zero_()
        changed = exe.run(prog, feed=feed, fetch_list=fetch)[0]
        assert not exe.last_cache_miss
    np.testing.assert_array_equal(again, runs[-1])
    assert not np.array_equal(changed, again)


def test_scan_layers_run_steps_equals_run_calls(cuda):
    """transformer(scan_layers=True) at fp32 with dropout 0.1: three
    captured steps equal three eager steps, and run_steps(3) three run
    calls, bit for bit in the losses and every scope variable."""
    avg_cost, feed = _small_transformer(0.1, scan_layers=True)
    res = _three_ways(cuda, avg_cost, feed)
    base_losses, base_vars = res['captured']
    assert np.isfinite(base_losses).all()
    for mode in ('eager', 'run_steps'):
        losses, vars_ = res[mode]
        np.testing.assert_array_equal(losses, base_losses, err_msg=mode)
        for n, v in base_vars.items():
            np.testing.assert_array_equal(vars_[n], v, err_msg=n)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_top_k_ties_on_the_card(cuda, dtype):
    """top_k on CUDA tensors returns lax.top_k's order: larger first, the
    lower index first on a tie (numpy's stable sort of the negated
    values), as on the host."""
    from paddle_tpu_torch.ops.tensor_ops import top_k
    every7 = np.zeros((1, 300), np.float32)
    every7[0, ::7] = 1.0
    one_live = np.full((1, 64), -1e30, np.float32)
    one_live[0, 3] = 0.5
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(256, 32000).astype(np.float32) * 3)
    logits = logits.to(torch.bfloat16).float().numpy()   # many ties
    for rows, k in ((every7, 5), (one_live, 4), (logits, 4)):
        x = torch.from_numpy(rows).to(dtype)
        vals, idx = top_k(x.to(cuda), k)
        want = np.argsort(-x.float().numpy(), axis=-1, kind='stable')[:, :k]
        np.testing.assert_array_equal(idx.cpu().numpy(), want)
        np.testing.assert_array_equal(idx.cpu().numpy(),
                                      top_k(x, k)[1].numpy())
        assert vals.dtype == dtype
    assert top_k(torch.from_numpy(every7).to(cuda), 5)[1].tolist() == \
        [[0, 7, 14, 21, 28]]


DECODE_FLASH = [(t, causal, dtype) for t in (1, 7, 16, 31)
                for causal in (True, False)
                for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize('case', DECODE_FLASH)
def test_flash_forward_at_the_decode_shapes(cuda, case):
    """K2 at the unrolled decoder's shapes on head-split views: causal
    self-attention over a prefix of t tokens (Tq = Tk = t) and
    cross-attention of t queries against 64 keys with kv_len 16-64,
    against both plain versions."""
    t, causal, dtype = case
    b, h, d = 32, 8, 64
    tk = t if causal else 64
    gen = torch.Generator(device=cuda).manual_seed(t)

    def heads(n):
        x = torch.randn(b, n, h * d, generator=gen, device=cuda).to(dtype)
        return x.view(b, n, h, d).transpose(1, 2)

    q, k, v = heads(t), heads(tk), heads(tk)
    lens = None if causal else torch.randint(16, 65, (b,), generator=gen,
                                             device=cuda)
    before = tfa.flash_fwd_cuda.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, lens, causal)
    assert tfa.flash_fwd_cuda.launches == before + 1
    for ref in (tfa.flash_attention_reference_fwd,
                tfa.flash_attention_tiled_reference_fwd):
        want, want_lse = ref(q, k, v, lens, causal)
        torch.cuda.synchronize()
        _close(out, want, dtype)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


# ---- the training lifecycle: schedules, clips, regularizers, restores

def _lifecycle_net(dropout):
    """_small_transformer's model with a global-norm clip set on the
    program: (loss, feed)."""
    from paddle_tpu_torch.models import transformer as T
    avg_cost, _ = T.transformer_base(
        src_vocab_size=96, trg_vocab_size=96, src_seq_len=24,
        trg_seq_len=24, n_layer=2, n_head=4, d_key=16, d_value=16,
        d_model=64, d_inner=128, dropout_rate=dropout)
    pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(0.5))
    return avg_cost, T.make_fake_batch(3, 24, 24, 96, 96, seed=2)


def _lifecycle_optimizer():
    """Adam on noam with L2 decay."""
    return pt.optimizer.Adam(
        learning_rate=pt.learning_rate_decay.noam_decay(64, 4),
        beta1=0.9, beta2=0.98, epsilon=1e-9,
        regularization=pt.regularizer.L2Decay(1e-4))


def _lifecycle_transformer(dropout):
    """noam, a global-norm clip and L2 decay on _small_transformer's
    model, every op of them inside the captured step."""
    pt.reset_default_programs()
    avg_cost, feed = _lifecycle_net(dropout)
    _lifecycle_optimizer().minimize(avg_cost)
    return avg_cost, feed


def test_captured_lifecycle_step_equals_eager_bit_for_bit(cuda):
    """noam (its step counter and lr_decay on the device), a global-norm
    clip and L2 decay at dropout 0.1: three captured steps equal three
    eager steps and run_steps(3), bit for bit in the losses and every
    scope variable (the counter included)."""
    avg_cost, feed = _lifecycle_transformer(0.1)
    res = _three_ways(cuda, avg_cost, feed)
    base_losses, base_vars = res['captured']
    assert np.isfinite(base_losses).all()
    assert '@LR_DECAY_COUNTER@' in base_vars
    for mode in ('eager', 'run_steps'):
        losses, vars_ = res[mode]
        np.testing.assert_array_equal(losses, base_losses, err_msg=mode)
        for n, v in base_vars.items():
            np.testing.assert_array_equal(vars_[n], v, err_msg=n)


def test_checkpoint_restore_into_a_live_executor_replays(cuda, tmp_path):
    """After io.load_checkpoint into the scope of an executor that has
    captured the step, the next step replays the same graph (no capture)
    and gives the loss the step after the save gave (dropout 0)."""
    from paddle_tpu_torch import io
    avg_cost, feed = _lifecycle_transformer(0.0)
    exe = pt.Executor(pt.CUDAPlace(0))
    d = str(tmp_path / 'ckpt')
    with pt.scope_guard(pt.Scope()):
        exe.run(pt.default_startup_program())
        for _ in range(3):
            exe.run(feed=feed, fetch_list=[avg_cost])
        assert exe.last_captured and exe.captures == 1
        io.save_checkpoint(exe, d, step=3)
        after = [exe.run(feed=feed, fetch_list=[avg_cost])[0]
                 for _ in range(2)]
        assert io.load_checkpoint(exe, d) == 3
        again = exe.run(feed=feed, fetch_list=[avg_cost])[0]
        assert exe.last_captured and exe.captures == 1
    np.testing.assert_array_equal(again, after[0])
    assert not np.array_equal(after[0], after[1])


def test_trainer_resume_on_the_card_is_bit_exact(cuda, tmp_path,
                                                 place=None):
    """A Trainer on the card at dropout 0.1 (checkpoints every 2 steps):
    a fresh Trainer resuming from step 2 in a fresh scope gives losses
    3-5 and every persistable of the uninterrupted run, bit for bit."""
    import os
    import shutil
    from paddle_tpu_torch.fault import CheckpointConfig
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.reader import checkpointable

    place = place or pt.CUDAPlace(0)

    def reader():
        for i in range(5):
            yield T.make_fake_batch(3, 24, 24, 96, 96, seed=i)

    def run(root, resume):
        log = []
        with pt.scope_guard(pt.Scope()):
            trainer = pt.Trainer(
                train_func=lambda: [_lifecycle_net(0.1)[0]],
                optimizer_func=_lifecycle_optimizer,
                place=place, checkpoint_config=CheckpointConfig(
                    root, save_every_steps=2, resume=resume,
                    epoch_end=False))
            trainer.train(1, log.append, reader=checkpointable(reader))
            state = {v.name: pt.global_scope().numpy(v.name)
                     for v in trainer.program.list_vars()
                     if v.persistable and not v.is_data}
        return [e.metrics[0] for e in log
                if isinstance(e, pt.EndStepEvent)], state

    pt.reset_default_programs()
    whole = str(tmp_path / 'whole')
    losses, state = run(whole, False)
    resumed = str(tmp_path / 'resumed')
    os.makedirs(resumed)
    shutil.copytree(os.path.join(whole, 'step_00000002'),
                    os.path.join(resumed, 'step_00000002'))
    pt.reset_default_programs()
    got, got_state = run(resumed, True)
    assert len(got) == 3
    for a, b in zip(got, losses[2:]):
        np.testing.assert_array_equal(a, b)
    for n, v in state.items():
        np.testing.assert_array_equal(got_state[n], v, err_msg=n)


# ------------------------------------------- disaggregated serving (PR 11)
@pytest.mark.parametrize('kv_dtype', ['float32', 'bfloat16', 'int8', 'fp8'])
def test_kv_packet_round_trip_on_the_card(cuda, kv_dtype):
    """The KV handoff on the card: export, to_bytes, from_bytes, install
    into a fresh engine, read_pages bit for bit (scales included); the
    installs write the arena tensors in place (no capture after warmup),
    and the receiving engine decodes the stream of one engine on the host
    with the same arena dtype."""
    from paddle_tpu_torch.serving import KVPacket, handoff
    spec = LMSpec(vocab_size=64, n_layer=2, n_head=2, d_key=16, d_value=16,
                  d_model=32, d_inner=64)
    geom = dict(max_batch=4, block_size=8, num_blocks=32, pages_per_seq=4,
                weights=random_weights(spec, seed=2), prefix_cache=True,
                kv_dtype=kv_dtype)
    prompt = np.random.RandomState(1).randint(0, 64, 21).tolist()
    src = DecodeEngine(spec, place=pt.CUDAPlace(0), **geom)
    dst = DecodeEngine(spec, place=pt.CUDAPlace(0), **geom)
    host = DecodeEngine(spec, place=pt.CPUPlace(), **geom)
    for eng in (src, dst, host):
        eng.warmup()
        eng.start()
    captures = dst.captures
    src.generate(prompt, max_new_tokens=1, timeout=120)
    pkt = handoff.export_packet(src, prompt)
    back = KVPacket.from_bytes(pkt.to_bytes())
    assert handoff.install_packet(dst, back) == (16, 2, 0)
    ids, _ = dst.prefix_cache.acquire(prompt)
    got = dst.read_pages(ids)
    dst.pool.free(ids)
    for name, t in pkt.arrays.items():
        assert t.device.type == 'cpu'
        assert torch.equal(got[name].view(torch.uint8),
                           t.view(torch.uint8)), name
        assert torch.equal(back.arrays[name].view(torch.uint8),
                           t.view(torch.uint8)), name
    want = host.generate(prompt, max_new_tokens=8, timeout=120)
    assert dst.generate(prompt, max_new_tokens=8, timeout=120) == want
    assert dst.captures == captures
    for eng in (src, dst, host):
        eng.shutdown()
        assert eng.free_pages() == eng.num_blocks


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dim', [1, 16])
@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum', 'adam'])
def test_sparse_rows_kernel_matches_plain(cuda, kind, dim, dtype):
    """The row-sparse update kernel against its plain version on the card,
    bit for bit: both sum a run's rows in sorted order and apply the same
    correctly rounded fp32 operations. Zipf ids (long runs of one id), ids
    past the table (dropped) and one launch a call."""
    from paddle_tpu_torch.ops.kernels import sparse_rows as S
    gen = torch.Generator(device=cuda).manual_seed(7)
    rng = np.random.RandomState(dim)
    vocab, n = 5000, 2048
    ids = (rng.zipf(1.1, n) - 1) % vocab
    ids[:3] = vocab + 1
    flat = torch.from_numpy(ids.astype('int64')).to(cuda)
    rows = torch.randn(n, dim, generator=gen, device=cuda).to(dtype)
    p = torch.randn(vocab, dim, generator=gen, device=cuda).to(dtype)
    state = [torch.rand(vocab, dim, generator=gen, device=cuda).to(dtype)
             for _ in range(S.N_STATE[kind])]
    lr = torch.tensor([0.05], device=cuda)
    pows = (torch.tensor([0.9 ** 4], device=cuda),
            torch.tensor([0.999 ** 4], device=cuda)) if kind == 'adam' else ()
    sids, order = S.sort_ids(flat)
    outs = []
    for fn in (S.sparse_rows_reference, S.sparse_rows):
        pp, ss = p.clone(), [s.clone() for s in state]
        before = S.sparse_rows.launches
        fn(kind, pp, rows, sids, order, lr, ss, pows)
        assert S.sparse_rows.launches - before == (fn is S.sparse_rows)
        outs.append([pp] + ss)
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    touched = torch.zeros(vocab, dtype=torch.bool, device=cuda)
    touched[flat[flat < vocab]] = True
    assert torch.equal(outs[1][0][~touched], p[~touched])
    assert not torch.equal(outs[1][0][touched], p[touched])


def _sparse_group(cuda, kind, dtype, shapes, seed, head=1.1):
    """SparseTables on the card, one a (vocab, dim, n) of ``shapes``: Zipf
    ids (long runs of one id) and ids past the table."""
    from paddle_tpu_torch.ops.kernels import sparse_rows as S
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rng = np.random.RandomState(seed)
    out = []
    for vocab, dim, n in shapes:
        ids = (rng.zipf(head, n) - 1) % vocab
        ids[:3] = vocab + np.arange(3)
        out.append(S.SparseTable(
            torch.randn(vocab, dim, generator=gen, device=cuda).to(dtype),
            torch.randn(n, dim, generator=gen, device=cuda).to(dtype),
            torch.from_numpy(ids.astype('int64')).to(cuda),
            [torch.rand(vocab, dim, generator=gen, device=cuda).to(dtype)
             for _ in range(S.N_STATE[kind])],
            [torch.tensor([0.9 ** 4], device=cuda),
             torch.tensor([0.999 ** 4], device=cuda)] if kind == 'adam'
            else []))
    return out


def _grouped_both(kind, tables, lr, hyper, launches):
    """The grouped kernel and its plain version on copies of ``tables``,
    checked bit for bit; the kernel launches ``launches`` times."""
    from paddle_tpu_torch.ops.kernels import sparse_rows as S
    outs = []
    for fn in (S.sparse_rows_grouped_reference, S.sparse_rows_grouped):
        copies = [t._replace(param=t.param.clone(),
                             state=tuple(s.clone() for s in t.state))
                  for t in tables]
        before = (S.sparse_rows.launches, S.sparse_rows.tables)
        fn(kind, copies, lr, **hyper)
        moved = (S.sparse_rows.launches - before[0],
                 S.sparse_rows.tables - before[1])
        assert moved == ((launches, len(tables))
                         if fn is S.sparse_rows_grouped else (0, 0))
        outs.append(copies)
    torch.cuda.synchronize()
    for got, want, start in zip(outs[1], outs[0], tables):
        assert torch.equal(got.param, want.param)
        for a, b in zip(got.state, want.state):
            assert torch.equal(a, b)
        touched = torch.zeros(start.param.shape[0], dtype=torch.bool,
                              device=start.param.device)
        touched[start.ids[start.ids < start.param.shape[0]]] = True
        assert torch.equal(got.param[~touched], start.param[~touched])
        assert not torch.equal(got.param[touched], start.param[touched])


@pytest.mark.parametrize('count', [1, 52])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum',
                                  'momentum_nesterov', 'adam'])
def test_sparse_rows_grouped_kernel_matches_plain(cuda, kind, dtype, count):
    """The grouped kernel (each table's ids sorted in its block) against
    its plain version, bit for bit, in one launch: one table, and 52
    tables of Wide&Deep's two widths (dims 16 and 1, 4,096 Zipf ids each;
    one table at 8,192 ids, one at 100, and dims 10 and 2,052: a column
    a thread, and more columns than threads)."""
    nesterov = kind == 'momentum_nesterov'
    kind = 'momentum' if nesterov else kind
    shapes = [(20000, 16 if i % 2 == 0 else 1, 4096) for i in range(count)]
    if count > 1:
        shapes[1] = (20000, 1, 8192)
        shapes[2] = (300, 16, 100)
        shapes[3] = (500, 10, 300)
        shapes[4] = (64, 2052, 40)
    tables = _sparse_group(cuda, kind, dtype, shapes, seed=count)
    lr = torch.tensor([0.05], device=cuda)
    hyper = dict(epsilon=1e-8 if kind == 'adam' else 1e-6,
                 use_nesterov=nesterov)
    _grouped_both(kind, tables, lr, hyper, launches=1)


@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'momentum', 'adam'])
def test_sparse_rows_large_tables_take_the_presorted_variant(cuda, kind):
    """Tables above 8,192 ids (65,536 Zipf ids; 20,000 ids of one value,
    one run across five blocks' chunks) take the presorted variant in a
    second launch beside the small table's, fp32 and bf16, bit for bit
    with the plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        tables = _sparse_group(cuda, kind, dtype, [
            (100000, 16, 65536), (5000, 1, 4096), (100000, 1, 65536)],
            seed=11)
        same = tables[2].ids.clone()
        same[3:20003] = 77
        tables[2] = tables[2]._replace(ids=same)
        _grouped_both(kind, tables, torch.tensor([0.05], device=cuda),
                      dict(epsilon=1e-8 if kind == 'adam' else 1e-6),
                      launches=2)


def test_sparse_rows_grouped_captured_equals_eager(cuda):
    """A grouped launch captured in a CUDA graph and replayed gives the
    eager launch's bits; the descriptors come with the launch (nothing is
    read on the host at replay)."""
    from paddle_tpu_torch.ops.kernels import sparse_rows as S
    tables = _sparse_group(cuda, 'adam', torch.float32,
                           [(20000, 16, 4096), (20000, 1, 4096)] * 8, 21)
    lr = torch.tensor([0.01], device=cuda)
    eager = [t._replace(param=t.param.clone(),
                        state=tuple(s.clone() for s in t.state))
             for t in tables]
    captured = [t._replace(param=t.param.clone(),
                           state=tuple(s.clone() for s in t.state))
                for t in tables]
    S.sparse_rows_grouped('adam', eager, lr, epsilon=1e-8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        S.sparse_rows_grouped('adam', captured, lr, epsilon=1e-8)
    for t, s in zip(captured, tables):
        assert torch.equal(t.param, s.param)      # capture ran nothing
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a.param, b.param)
        for x, y in zip(a.state, b.state):
            assert torch.equal(x, y)


def test_captured_wide_deep_step_uses_the_kernel_and_equals_eager(cuda):
    """Wide&Deep (4 slots x 1,000 rows, batch 256) under lazy Adam: the
    step's 8 table updates are one sparse_rows launch, captured steps equal
    eager ones bit for bit, and the card agrees with the host."""
    from paddle_tpu_torch.models import wide_deep as W
    from paddle_tpu_torch.ops.kernels import sparse_rows as S

    def build():
        pt.reset_default_programs()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            _, cost, _, _ = W.build(num_slots=4, vocab_size=1000)
            pt.optimizer.Adam(1e-3, lazy_mode=True).minimize(cost)
        return main, startup, cost

    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(3):
        f = {'C%d' % i: ((rng.zipf(1.2, (256, 1)) - 1) % 1000)
             .astype('int64') for i in range(4)}
        f['dense'] = rng.rand(256, 13).astype('f')
        f['label'] = rng.randint(0, 2, (256, 1)).astype('int64')
        feeds.append(f)
    main, startup, cost = build()
    names = [v.name for v in main.list_vars()
             if v.persistable and not v.is_data]
    host_scope = pt.Scope()
    with pt.scope_guard(host_scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    results = {}
    for mode in ('eager', 'captured', 'host'):
        scope = pt.Scope()
        place = pt.CPUPlace() if mode == 'host' else pt.CUDAPlace(0)
        exe = pt.Executor(place)
        dev = place.device()
        for n in names:
            scope.set(n, host_scope.find(n).clone().to(dev))
        before = (S.sparse_rows.launches, S.sparse_rows.tables)
        losses = []
        with pt.scope_guard(scope):
            for f in feeds:
                loss, = exe.run(main, feed=f, fetch_list=[cost],
                                use_program_cache=mode == 'captured')
                losses.append(float(loss.reshape(())))
        if mode == 'captured':
            assert exe.last_captured
        if mode != 'host':
            assert (S.sparse_rows.launches - before[0],
                    S.sparse_rows.tables - before[1]) == (3, 3 * 8)
        results[mode] = (losses, {n: scope.find(n).cpu() for n in names})
    assert results['eager'][0] == results['captured'][0]
    for n in names:
        assert torch.equal(results['eager'][1][n], results['captured'][1][n])
        torch.testing.assert_close(results['captured'][1][n],
                                   results['host'][1][n], rtol=1e-5,
                                   atol=2e-7)
    np.testing.assert_allclose(results['captured'][0], results['host'][0],
                               rtol=1e-5)


# ------------------------------------------ the repaired faults on the card
# the edge values (NaN, +-inf, +-0, the clips' bounds, beyond int32), the
# places of the repaired faults and the tolerance rule are chip_smoke.py's,
# as tests/test_torch_harness.py and phase 16b hold them
FAULT_EDGE = LAYERS_EDGE
# each repaired fault's op, and whether its values are exact
CARD_FAULTS = {
    'sign': (lambda L, x: L.sign(x), True),
    'gelu': (lambda L, x: L.gelu(x), False),
    'cast': (lambda L, x: [L.cast(x, d) for d in
                           ('int32', 'int16', 'int8', 'uint8', 'bool')],
             True),
    'pow': (lambda L, x: L.pow(x, factor=0.5), False),
    'clip': (lambda L, x: L.clip(x, -1.5, 2.5), True),
    'brelu': (lambda L, x: L.brelu(x, t_min=0.0, t_max=24.0), True),
    'relu6': (lambda L, x: L.relu6(x), True),
    'leaky_relu': (lambda L, x: L.leaky_relu(x), False),
}


def _fault_program(fault, amp):
    """x + a -0.0 probe (so the probe's gradient is the gradient at x),
    cast to bf16 under amp, then the op; the loss sums its float outputs.
    Returns (main, startup, fetch names)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name='x', shape=[4, 8], dtype='float32',
                   append_batch_size=False)
        probe = L.create_parameter(
            shape=[4, 8], dtype='float32', name='probe',
            default_initializer=pt.initializer.Constant(-0.0))
        xin = L.elementwise_add(x, probe)
        if amp:
            xin = L.cast(xin, 'bfloat16')
        outs = CARD_FAULTS[fault][0](L, xin)
        outs = outs if isinstance(outs, list) else [outs]
        fetch = [o.name for o in outs]
        floats = [o for o in outs if o.dtype in ('float32', 'bfloat16')]
        if floats:
            loss = L.reduce_sum(L.cast(floats[0], 'float32'))
            pt.backward.append_backward(loss)
            fetch.append('probe@GRAD')
    main.amp = amp
    return main, startup, fetch


@pytest.mark.parametrize('amp', [None, 'bf16'], ids=['fp32', 'bf16'])
@pytest.mark.parametrize('fault', sorted(CARD_FAULTS))
def test_repaired_fault_on_card_equals_host(cuda, fault, amp):
    """Each repaired fault on the edge values: on the card (eager, then
    captured) the value and gradient equal the host's exactly where the
    fault was (NaN, +-inf, beyond int32, a clip's bounds, 0), and within
    chip_smoke.py's parity_difference elsewhere (exact for an exact op);
    the host's equal the JAX package's (tests/test_torch_harness.py)."""
    main, startup, fetch = _fault_program(fault, amp)
    where = LAYERS_FAULTS[fault](FAULT_EDGE)
    exact = CARD_FAULTS[fault][1]
    got = {}
    for mode in ('eager', 'captured', 'host'):
        place = pt.CPUPlace() if mode == 'host' else pt.CUDAPlace(0)
        exe = pt.Executor(place)
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            for _ in range(2 if mode == 'captured' else 1):
                out = exe.run(main, feed={'x': FAULT_EDGE}, fetch_list=fetch,
                              use_program_cache=mode == 'captured')
            if mode == 'captured':
                assert exe.last_captured
        got[mode] = [np.asarray(v).astype(np.float64) for v in out]
    for i, (e, c, h) in enumerate(zip(got['eager'], got['captured'],
                                      got['host'])):
        np.testing.assert_array_equal(c, e)
        np.testing.assert_array_equal(c[where], h[where])
        grad = fetch[i] == 'probe@GRAD'
        assert parity_difference(
            c, h, exact, amp is not None, grad,
            where=ordinary(h.shape, FAULT_EDGE)) is None, (fetch[i], c, h)


# ------------------------------------------ the staging ring on the card
def test_staging_ring_pinned_slots_round_trip(cuda):
    """staged_superbatch on the card: every slot page-locked once before
    its first copy, each window on the card equal to np.stack of its
    batches bit for bit, and a pageable array refused by
    fields_to_device."""
    from paddle_tpu_torch.reader import staging
    rng = np.random.RandomState(0)
    data = [{'x': rng.randn(64, 512).astype('f'),
             'i': rng.randint(0, 1000, (64, 1)).astype('int64')}
            for _ in range(13)]
    reader = staging.staged_superbatch(lambda: iter(data), 4, n_buffers=3,
                                       place=pt.CUDAPlace(0))
    windows = list(reader())
    assert len(windows) == 3
    stats = reader.stats
    assert (stats['rings'], stats['slots_pinned'], stats['windows']) == \
        (1, 3, 3) and stats['pin_seconds'] > 0
    for k, w in enumerate(windows):
        for n in ('x', 'i'):
            assert w[n].device == cuda
            want = np.stack([data[4 * k + j][n] for j in range(4)])
            np.testing.assert_array_equal(w[n].cpu().numpy(), want)
    with pytest.raises(RuntimeError, match='pageable'):
        staging.fields_to_device({'x': data[0]['x']}, cuda)


def test_prefetch_to_device_on_card_is_mutation_safe(cuda):
    """A reader that overwrites its buffer after every yield: each batch
    prefetched to the card keeps the value it had when it was read."""
    from paddle_tpu_torch.reader import decorator
    buf = np.zeros((256, 128), dtype='float32')

    def reuse_reader():
        for i in range(6):
            buf[:] = i
            yield {'x': buf}
    got = [b['x'] for b in decorator.prefetch_to_device(
        reuse_reader, buffer_size=2, place=pt.CUDAPlace(0))()]
    assert len(got) == 6
    for i, t in enumerate(got):
        assert t.device == cuda
        assert torch.equal(t.cpu(), torch.full((256, 128), float(i)))


def _scatter_program():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        L = pt.layers
        x = L.data(name='x', shape=[512, 64], dtype='float32',
                   append_batch_size=False)
        u = L.data(name='u', shape=[4096, 64], dtype='float32',
                   append_batch_size=False)
        ids = L.data(name='ids', shape=[4096, 1], dtype='int64',
                     append_batch_size=False)
        px = L.create_parameter([512, 64], 'float32', name='px',
                                default_initializer=pt.initializer.Constant(
                                    -0.0))
        pu = L.create_parameter([4096, 64], 'float32', name='pu',
                                default_initializer=pt.initializer.Constant(
                                    -0.0))
        out = L.scatter(L.elementwise_add(x, px), ids,
                        L.elementwise_add(u, pu))
        loss = L.reduce_sum(L.elementwise_mul(out, out))
        pt.backward.append_backward(loss)
    return main, startup, [out.name, 'px@GRAD', 'pu@GRAD']


def test_scatter_repeated_ids_card_equals_host(cuda):
    """scatter with every id repeated 8 times in a shuffled order: on the
    card (eager, then captured) the last update of each id wins, as on
    the host, and the values and both gradients equal the host's bit for
    bit."""
    rng = np.random.RandomState(1)
    ids = rng.permutation(np.repeat(np.arange(512), 8))[:, None]
    feed = {'x': rng.randn(512, 64).astype('f'),
            'u': rng.randn(4096, 64).astype('f'), 'ids': ids}
    main, startup, fetch = _scatter_program()
    got = {}
    for mode in ('eager', 'captured', 'host'):
        place = pt.CPUPlace() if mode == 'host' else pt.CUDAPlace(0)
        exe = pt.Executor(place)
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            for _ in range(2 if mode == 'captured' else 1):
                out = exe.run(main, feed=feed, fetch_list=fetch,
                              use_program_cache=mode == 'captured')
            if mode == 'captured':
                assert exe.last_captured
        got[mode] = out
    last = {int(i): k for k, i in enumerate(ids[:, 0])}
    want = feed['u'][[last[r] for r in range(512)]]
    np.testing.assert_array_equal(got['host'][0], want)
    for mode in ('eager', 'captured'):
        for a, b in zip(got[mode], got['host']):
            np.testing.assert_array_equal(a, b)
