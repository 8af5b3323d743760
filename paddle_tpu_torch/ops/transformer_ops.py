"""Slot layout of the stacked transformer-layer weights (reference:
paddle_tpu ops/transformer_ops.py). Only the pieces the decode ops use are
here; the layer-stack op itself belongs to the training slice."""

ENC_SLOTS = ('slf_q', 'slf_k', 'slf_v', 'slf_o', 'ln1_w', 'ln1_b',
             'ffn_w1', 'ffn_b1', 'ffn_w2', 'ffn_b2', 'ln2_w', 'ln2_b')


def _slot_to_input(slot):
    """'slf_q' -> the op input slot name 'SlfQ'."""
    return ''.join(part.capitalize() for part in slot.split('_'))
