"""Beam search layers (reference: paddle_tpu layers/decode.py): one
beam_search step over static [B, beam(, K)] arrays, beam_search_decode's
backtrack, and beam_gather. The CTC and CRF layers are not ported."""

from .helper import LayerHelper

__all__ = ['beam_search', 'beam_search_decode', 'beam_gather']


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
