"""Program builder for the decode engine's decoder-only LM (reference:
paddle_tpu serving/decode/model.py).

Builds the Programs the engine drives through one Executor + Scope, all
sharing one parameter namespace (prefix ``lm_``):

- **startup** — initializes the stacked GPT-block weights
  (models.transformer._stacked_layer_params layout, ENC_SLOTS), token
  embedding, sinusoid position table, output projection, and the two
  zeroed KV page arenas ``[L, NB, H, bs, d]``; quantized (int8 / fp8)
  arenas also get fp32 scale arenas ``[L, NB, H, bs]``, one scale a
  stored row. The arenas are persistable scope state that the decode ops
  update in place.
- **prefill** — the ``paged_prefill`` op over feeds (ids [1, S], len,
  cached-prefix length, block table row, temp, seed); S is the bucket of
  the uncached suffix.
- **decode** — the ``paged_decode_step`` op over fixed [max_batch] feeds.
- **verify** (only when ``spec_k > 0``) — the ``paged_spec_verify`` op
  over fixed [max_batch, spec_k+1] feeds (k a static attr).

Parameter names are the reference's, so its weights load as they are.
"""

import collections

import numpy as np

from ... import layers
from ...core.program import Program, program_guard
from ...initializer import Constant, Normal, NumpyArrayInitializer
from ...layers.helper import LayerHelper
from ...models.transformer import (_stacked_layer_params,
                                   position_encoding_table)
from ...ops.transformer_ops import _slot_to_input
from ...param_attr import ParamAttr
from ...quant.core import kv_itemsize, kv_quantized, resolve_kv_dtype

__all__ = ['LMSpec', 'DecodePrograms', 'build_lm_programs',
           'kv_bytes_per_token', 'arena_bytes', 'kv_page_bytes',
           'num_blocks_for_budget', 'random_weights']


class LMSpec(object):
    """Decoder-only LM hyperparameters (GPT block: causal self-attn +
    FFN, residual+LN layout shared with the NMT encoder)."""

    def __init__(self, vocab_size, n_layer=2, n_head=2, d_key=16,
                 d_value=16, d_model=32, d_inner=64):
        self.vocab_size = int(vocab_size)
        self.n_layer = int(n_layer)
        self.n_head = int(n_head)
        self.d_key = int(d_key)
        self.d_value = int(d_value)
        self.d_model = int(d_model)
        self.d_inner = int(d_inner)


DecodePrograms = collections.namedtuple(
    'DecodePrograms',
    ['startup', 'prefill', 'decode', 'verify', 'prefill_fetch',
     'decode_fetch', 'verify_fetch', 'param_names', 'arena_names',
     'capacity', 'kv_dtype'])


def kv_bytes_per_token(spec, kv_dtype='float32'):
    """Device bytes one cached token costs across all layers: the K/V
    rows at the arena dtype plus (for quantized arenas) the per-token
    per-head fp32 scale pair."""
    item = kv_itemsize(kv_dtype)
    b = spec.n_layer * spec.n_head * (spec.d_key + spec.d_value) * item
    if kv_quantized(kv_dtype):
        b += spec.n_layer * spec.n_head * 2 * 4   # k + v scale rows
    return b


def arena_bytes(spec, num_blocks, block_size, kv_dtype='float32'):
    """Total bytes of the K/V (+ scale) arenas."""
    return kv_bytes_per_token(spec, kv_dtype) * int(num_blocks) * \
        int(block_size)


def kv_page_bytes(spec, block_size, kv_dtype='float32'):
    """Bytes one FULL page costs: its K/V rows at the arena dtype plus,
    for quantized arenas, its per-row fp32 scales."""
    return kv_bytes_per_token(spec, kv_dtype) * int(block_size)


def num_blocks_for_budget(budget_bytes, spec, block_size,
                          kv_dtype='float32'):
    """Pages an arena byte budget buys at ``kv_dtype``."""
    return max(1, int(budget_bytes) // kv_page_bytes(spec, block_size,
                                                     kv_dtype))


def _lm_params(spec, capacity):
    """Declare the shared parameter set in the CURRENT program (and its
    init ops in the current startup, first declaration wins)."""
    stacked = _stacked_layer_params(
        'lm_stack', spec.n_layer, spec.n_head, spec.d_key, spec.d_value,
        spec.d_model, spec.d_inner, decoder=False)
    emb = layers.create_parameter(
        shape=[spec.vocab_size, spec.d_model], dtype='float32',
        name='lm_emb',
        attr=ParamAttr(name='lm_emb',
                       initializer=Normal(0., spec.d_model ** -0.5)))
    pos = layers.create_parameter(
        shape=[capacity, spec.d_model], dtype='float32',
        name='lm_pos_enc',
        attr=ParamAttr(name='lm_pos_enc',
                       initializer=NumpyArrayInitializer(
                           position_encoding_table(capacity,
                                                   spec.d_model)),
                       trainable=False))
    wout = layers.create_parameter(
        shape=[spec.d_model, spec.vocab_size], dtype='float32',
        name='lm_out_proj.w', attr=ParamAttr(name='lm_out_proj.w'))
    return stacked, emb, pos, wout


def _arenas(spec, num_blocks, block_size, kv_dtype='float32'):
    """Zeroed K/V page arenas at ``kv_dtype``; quantized dtypes also get
    per-(page, head, slot) fp32 scale arenas, so a page's stored bits are
    a pure function of the tokens written into it and prefix-cache sharing
    carries the scales along (same physical page index)."""
    shapes = {
        'lm_kcache': [spec.n_layer, num_blocks, spec.n_head, block_size,
                      spec.d_key],
        'lm_vcache': [spec.n_layer, num_blocks, spec.n_head, block_size,
                      spec.d_value],
    }
    out = {}
    for name, shape in shapes.items():
        out[name] = layers.create_parameter(
            shape=shape, dtype=kv_dtype, name=name,
            attr=ParamAttr(name=name, initializer=Constant(0.0),
                           trainable=False))
    ks = vs = None
    if kv_quantized(kv_dtype):
        sshape = [spec.n_layer, num_blocks, spec.n_head, block_size]
        ks, vs = [layers.create_parameter(
            shape=sshape, dtype='float32', name=name,
            attr=ParamAttr(name=name, initializer=Constant(1.0),
                           trainable=False))
            for name in ('lm_kscale', 'lm_vscale')]
    return out['lm_kcache'], out['lm_vcache'], ks, vs


def _common_inputs(stacked, emb, pos, wout, kc, vc, ks=None, vs=None):
    inputs = {'Emb': [emb], 'PosEnc': [pos], 'OutProj': [wout],
              'KCache': [kc], 'VCache': [vc]}
    if ks is not None:
        inputs['KScale'] = [ks]
        inputs['VScale'] = [vs]
    for slot, param in stacked.items():
        inputs[_slot_to_input(slot)] = [param]
    return inputs


def _arena_outputs(kc, vc, ks=None, vs=None):
    outputs = {'KCacheOut': [kc], 'VCacheOut': [vc]}
    if ks is not None:
        outputs['KScaleOut'] = [ks]
        outputs['VScaleOut'] = [vs]
    return outputs


def _step_op(op_type, feeds, spec, block_size, kv_dtype, num_blocks,
             capacity, out_shape, attrs=None):
    """Declare the shared parameters and arenas in the current program and
    append one ``op_type`` op over them and ``feeds`` ({slot: var});
    returns its next-token output's name."""
    stacked, emb, pos, wout = _lm_params(spec, capacity)
    kc, vc, ks, vs = _arenas(spec, num_blocks, block_size, kv_dtype)
    helper = LayerHelper(op_type, name=op_type)
    nxt = helper.create_variable_for_type_inference('int64')
    nxt.shape = out_shape
    inputs = _common_inputs(stacked, emb, pos, wout, kc, vc, ks, vs)
    inputs.update({slot: [var] for slot, var in feeds.items()})
    out_slot = 'NextToken' if op_type == 'paged_prefill' else 'NextTokens'
    outputs = dict(_arena_outputs(kc, vc, ks, vs), **{out_slot: [nxt]})
    helper.append_op(type=op_type, inputs=inputs, outputs=outputs,
                     attrs=dict({'n_head': spec.n_head,
                                 'block_size': int(block_size)},
                                **(attrs or {})))
    return nxt.name, stacked, ks


def build_lm_programs(spec, max_batch, block_size, num_blocks,
                      pages_per_seq, spec_k=0, kv_dtype='float32'):
    """Returns DecodePrograms. ``capacity`` (= pages_per_seq *
    block_size) bounds prompt_len + max_new_tokens per sequence.
    ``spec_k > 0`` also builds the speculative-decoding verify Program
    ([max_batch, spec_k+1] feeds). ``kv_dtype`` (fp32 default / bf16 /
    int8 / fp8) sets the arena storage dtype; quantized arenas carry fp32
    scale arenas beside them."""
    kv_dtype = resolve_kv_dtype(kv_dtype)
    capacity = int(pages_per_seq) * int(block_size)
    spec_k = int(spec_k)
    geom = dict(spec=spec, block_size=block_size, kv_dtype=kv_dtype,
                num_blocks=num_blocks, capacity=capacity)
    startup = Program()
    prefill_prog = Program()
    decode_prog = Program()

    with program_guard(prefill_prog, startup):
        feeds = {
            'Ids': layers.data(name='pf_ids', shape=[-1], dtype='int64'),
            'Len': layers.data(name='pf_len', shape=[], dtype='int32'),
            'Cached': layers.data(name='pf_cached', shape=[],
                                  dtype='int32'),
            'BlockTable': layers.data(name='pf_table',
                                      shape=[pages_per_seq], dtype='int32'),
            'Temp': layers.data(name='pf_temp', shape=[], dtype='float32'),
            'Seed': layers.data(name='pf_seed', shape=[], dtype='int32')}
        prefill_fetch, stacked, ks = _step_op('paged_prefill', feeds,
                                              out_shape=(1,), **geom)

    def batch_feeds(prefix, token_shape):
        return {
            'Tokens': layers.data(name=prefix + '_tokens',
                                  shape=token_shape, dtype='int64'),
            'SeqLens': layers.data(name=prefix + '_lens', shape=[],
                                   dtype='int32'),
            'BlockTables': layers.data(name=prefix + '_tables',
                                       shape=[pages_per_seq],
                                       dtype='int32'),
            'Temps': layers.data(name=prefix + '_temps', shape=[],
                                 dtype='float32'),
            'Seeds': layers.data(name=prefix + '_seeds', shape=[],
                                 dtype='int32')}

    with program_guard(decode_prog, startup):
        decode_fetch, _, _ = _step_op('paged_decode_step',
                                      batch_feeds('dec', []),
                                      out_shape=(max_batch,), **geom)

    verify_prog, verify_fetch = None, None
    if spec_k > 0:
        verify_prog = Program()
        with program_guard(verify_prog, startup):
            verify_fetch, _, _ = _step_op(
                'paged_spec_verify', batch_feeds('sv', [spec_k + 1]),
                out_shape=(max_batch, spec_k + 1), attrs={'k': spec_k},
                **geom)

    param_names = sorted(
        {'lm_emb', 'lm_pos_enc', 'lm_out_proj.w'} |
        {p.name for p in stacked.values()})
    arena_names = ('lm_kcache', 'lm_vcache')
    if ks is not None:
        arena_names += ('lm_kscale', 'lm_vscale')
    return DecodePrograms(
        startup=startup, prefill=prefill_prog, decode=decode_prog,
        verify=verify_prog, prefill_fetch=prefill_fetch,
        decode_fetch=decode_fetch, verify_fetch=verify_fetch,
        param_names=param_names, arena_names=arena_names,
        capacity=capacity, kv_dtype=kv_dtype)


def random_weights(spec, seed=0):
    """Deterministic numpy weight set matching build_lm_programs'
    parameter names: the same arrays as the reference's random_weights
    for the same (spec, seed)."""
    rng = np.random.RandomState(seed)
    d, dk, dv = spec.d_model, spec.d_key, spec.d_value
    h, L = spec.n_head, spec.n_layer

    def mat(*shape):
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        return (rng.randn(*shape) * (1.0 / np.sqrt(fan))) \
            .astype('float32')

    w = {
        'lm_emb': (rng.randn(spec.vocab_size, d) * d ** -0.5)
        .astype('float32'),
        'lm_out_proj.w': mat(d, spec.vocab_size),
        'lm_stack_slf_q.w': mat(L, d, dk * h),
        'lm_stack_slf_k.w': mat(L, d, dk * h),
        'lm_stack_slf_v.w': mat(L, d, dv * h),
        'lm_stack_slf_o.w': mat(L, dv * h, d),
        'lm_stack_ffn_1.w': mat(L, d, spec.d_inner),
        'lm_stack_ffn_1.b': np.zeros((L, spec.d_inner), 'float32'),
        'lm_stack_ffn_2.w': mat(L, spec.d_inner, d),
        'lm_stack_ffn_2.b': np.zeros((L, d), 'float32'),
        'lm_stack_ln1.w': np.ones((L, d), 'float32'),
        'lm_stack_ln1.b': np.zeros((L, d), 'float32'),
        'lm_stack_ln2.w': np.ones((L, d), 'float32'),
        'lm_stack_ln2.b': np.zeros((L, d), 'float32'),
    }
    return w
