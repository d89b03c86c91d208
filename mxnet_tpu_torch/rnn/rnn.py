"""RNN checkpoint helpers of the port (reference: ``mxnet_tpu/rnn/rnn.py``):
the fused cells' blobs are unpacked into per-cell weights before a
checkpoint is written and packed again after one is read, over the
byte-compatible ``.params`` format, so either package reads the other's
files."""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cells_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Unpacks fused cell weights before saving (reference: rnn.py:28)."""
    args = dict(arg_params)
    for cell in _cells_list(cells):
        args = cell.unpack_weights(args)
    save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """reference: rnn.py:56."""
    sym, args, auxs = load_checkpoint(prefix, epoch)
    for cell in _cells_list(cells):
        args = cell.pack_weights(args)
    return sym, args, auxs


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch callback (reference: rnn.py:84)."""
    period = max(1, period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
