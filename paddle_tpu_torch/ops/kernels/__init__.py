"""Hand-written CUDA kernels for Hopper (sources in ``paddle_tpu_torch/csrc``),
each beside its plain PyTorch version. Counterpart of paddle_tpu's
``ops/pallas/``."""


def launch_counters():
    """[(name, wrapper, attribute)]: every kernel launch count of the port
    (each wrapper adds one where it launches its kernel, and nowhere else),
    the batch norm backward's count of gradients copied into x's layout,
    and the row-sparse update's count of tables updated. The executor
    moves them by a captured graph's launches at each replay;
    chip_smoke.py reads them."""
    from . import flash_attention as fa
    from .batch_norm import fused_batch_norm_train
    from .kv_write import kv_write
    from .layer_norm import fused_layer_norm
    from .max_pool import max_pool_bwd, max_pool_fwd
    from .paged_attention import paged_attention
    from .random_bits import fused_dropout, keep_mask
    from .rnn_cell import gru_cell_bwd, gru_cell_fwd, gru_seq_bwd, \
        gru_seq_fwd, gru_wide_bwd, gru_wide_fwd, lstm_cell_bwd, \
        lstm_cell_fwd, lstm_seq_bwd, lstm_seq_fwd
    from .sparse_rows import sparse_rows
    res = [('layer_norm', fused_layer_norm, 'launches'),
           ('layer_norm_bwd', fused_layer_norm, 'bwd_launches'),
           ('paged_attention', paged_attention, 'launches'),
           ('paged_attention_v16', paged_attention, 'launches_v16'),
           ('paged_attention_any', paged_attention, 'launches_any'),
           ('paged_attention_q8', paged_attention, 'launches_q8'),
           ('paged_attention_write', paged_attention, 'launches_write'),
           ('batch_norm', fused_batch_norm_train, 'launches'),
           ('batch_norm_bwd', fused_batch_norm_train, 'bwd_launches'),
           ('batch_norm_bwd_gy_copies', fused_batch_norm_train,
            'bwd_gy_copies'),
           ('kv_write', kv_write, 'launches'),
           ('keep_mask', keep_mask, 'launches'),
           ('dropout', fused_dropout, 'launches'),
           ('dropout_bwd', fused_dropout, 'bwd_launches'),
           ('sparse_rows', sparse_rows, 'launches'),
           ('sparse_rows_tables', sparse_rows, 'tables'),
           ('lstm_cell_fwd', lstm_cell_fwd, 'launches'),
           ('lstm_cell_bwd', lstm_cell_bwd, 'launches'),
           ('lstm_seq_fwd', lstm_seq_fwd, 'launches'),
           ('lstm_seq_bwd', lstm_seq_bwd, 'launches'),
           ('gru_cell_fwd', gru_cell_fwd, 'launches'),
           ('gru_cell_bwd', gru_cell_bwd, 'launches'),
           ('gru_seq_fwd', gru_seq_fwd, 'launches'),
           ('gru_seq_bwd', gru_seq_bwd, 'launches'),
           ('gru_wide_fwd', gru_wide_fwd, 'launches'),
           ('gru_wide_bwd', gru_wide_bwd, 'launches'),
           ('max_pool_fwd', max_pool_fwd, 'launches'),
           ('max_pool_bwd', max_pool_bwd, 'launches')]
    for name, fn in (('flash_attention_fwd', fa.flash_fwd_cuda),
                     ('flash_attention_bwd_dkv', fa.flash_bwd_dkv_cuda),
                     ('flash_attention_bwd_dq', fa.flash_bwd_dq_cuda)):
        res += [(name, fn, 'launches'), (name + '_mma', fn, 'launches_mma'),
                (name + '_simt', fn, 'launches_simt')]
    return res
