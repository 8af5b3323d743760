"""Structured prediction and beam search layers (reference: paddle_tpu
layers/decode.py): the CTC loss and greedy decoder, the linear-chain
CRF's loss and Viterbi decode over padded [batch, max_len, ...] inputs
with an optional per-example ``length`` Variable, one beam_search step
over static [B, beam(, K)] arrays, beam_search_decode's backtrack, and
beam_gather."""

from .helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    'warpctc', 'ctc_greedy_decoder', 'linear_chain_crf', 'crf_decoding',
    'beam_search', 'beam_search_decode', 'beam_gather',
]


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss. input: [B, T, num_classes+1] unnormalized logits;
    label: [B, L] int; returns [B, 1] loss."""
    helper = LayerHelper('warpctc')
    loss = helper.create_variable_for_type_inference('float32')
    if input.shape is not None:
        loss.shape = (input.shape[0], 1)
    inputs = {'Logits': [input], 'Label': [label]}
    if input_length is not None:
        inputs['LogitsLength'] = [input_length]
    if label_length is not None:
        inputs['LabelLength'] = [label_length]
    helper.append_op(type='warpctc', inputs=inputs,
                     outputs={'Loss': [loss]},
                     attrs={'blank': blank, 'norm_by_times': norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, input_length=None):
    """Greedy decode: argmax over classes, merge repeats, strip blanks.
    input: [B, T, C] probs/logits. Returns (decoded [B, T] int64 padded
    with -1, out_length [B, 1] int64)."""
    from . import tensor as _tensor
    ids = _tensor.argmax(input, axis=-1)
    helper = LayerHelper('ctc_greedy_decoder')
    out = helper.create_variable_for_type_inference('int64')
    out_len = helper.create_variable_for_type_inference('int64')
    if input.shape is not None:
        out.shape = (input.shape[0], input.shape[1])
        out_len.shape = (input.shape[0], 1)
    inputs = {'Input': [ids]}
    if input_length is not None:
        inputs['Length'] = [input_length]
    helper.append_op(type='ctc_align', inputs=inputs,
                     outputs={'Output': [out], 'OutputLength': [out_len]},
                     attrs={'blank': blank})
    return out, out_len


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood. input: [B, T, C] emissions;
    label: [B, T] int tags. The transition parameter has shape
    [C+2, C] (linear_chain_crf_op.cc layout: start row, stop row,
    then C×C transitions)."""
    helper = LayerHelper('linear_chain_crf', param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype='float32')
    nll = helper.create_variable_for_type_inference('float32')
    if input.shape is not None:
        nll.shape = (input.shape[0], 1)
    inputs = {'Emission': [input], 'Transition': [transition],
              'Label': [label]}
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(type='linear_chain_crf', inputs=inputs,
                     outputs={'LogLikelihood': [nll]}, attrs={})
    return nll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the trained CRF transitions. Without `label`
    returns the best path [B, T] int64; with `label` returns per-position
    correctness indicators (reference crf_decoding_op.h semantics)."""
    helper = LayerHelper('crf_decoding')
    trans_name = param_attr.name if isinstance(param_attr, ParamAttr) \
        else param_attr
    transition = helper.main_program.global_block()._find_var_recursive(
        trans_name)
    if transition is None:
        raise ValueError('crf_decoding: no CRF transition parameter named '
                         '%r — pass the same param_attr used by '
                         'linear_chain_crf' % trans_name)
    out = helper.create_variable_for_type_inference('int64')
    if input.shape is not None:
        out.shape = (input.shape[0], input.shape[1])
    inputs = {'Emission': [input], 'Transition': [transition]}
    if label is not None:
        inputs['Label'] = [label]
    if length is not None:
        inputs['Length'] = [length]
    helper.append_op(type='crf_decoding', inputs=inputs,
                     outputs={'ViterbiPath': [out]}, attrs={})
    return out




def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                name=None):
    """One beam-search step. Returns (selected_ids [B, beam],
    selected_scores [B, beam], parent_idx [B, beam])."""
    helper = LayerHelper(name or 'beam_search')
    sel_ids = helper.create_variable_for_type_inference('int64')
    sel_scores = helper.create_variable_for_type_inference('float32')
    parent = helper.create_variable_for_type_inference('int64')
    if ids.shape is not None:
        for v in (sel_ids, sel_scores, parent):
            v.shape = (ids.shape[0], beam_size)
    helper.append_op(
        type='beam_search',
        inputs={'pre_ids': [pre_ids], 'pre_scores': [pre_scores],
                'ids': [ids], 'scores': [scores]},
        outputs={'selected_ids': [sel_ids],
                 'selected_scores': [sel_scores],
                 'parent_idx': [parent]},
        attrs={'beam_size': beam_size, 'end_id': end_id})
    return sel_ids, sel_scores, parent


def beam_search_decode(step_ids, step_parents, final_scores=None,
                       beam_size=None, end_id=0, name=None):
    """Backtrack the stacked per-step selections [T, B, beam] into
    sentences [B, beam, T]. Returns (sentence_ids, sentence_scores)."""
    helper = LayerHelper(name or 'beam_search_decode')
    sent = helper.create_variable_for_type_inference('int64')
    sent_scores = helper.create_variable_for_type_inference('float32')
    if step_ids.shape is not None:
        t, b, beam = step_ids.shape
        sent.shape = (b, beam, t)
        sent_scores.shape = (b, beam)
    inputs = {'StepIds': [step_ids], 'StepParents': [step_parents]}
    if final_scores is not None:
        inputs['FinalScores'] = [final_scores]
    helper.append_op(type='beam_search_decode', inputs=inputs,
                     outputs={'SentenceIds': [sent],
                              'SentenceScores': [sent_scores]},
                     attrs={'end_id': end_id})
    return sent, sent_scores


def beam_gather(x, index, name=None):
    """Reorder the beam axis (1) of ``x`` by the per-example ``index``
    ([B, beam] int)."""
    helper = LayerHelper(name or 'beam_gather')
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None:
        out.shape = tuple(x.shape)
    helper.append_op(type='beam_gather',
                     inputs={'X': [x], 'Index': [index]},
                     outputs={'Out': [out]}, attrs={})
    return out
