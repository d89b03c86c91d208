"""``mx.rnn`` of the port (reference: ``mxnet_tpu/rnn/``): the symbolic
cells and ``unroll`` of the ``BucketingModule`` workflow, the bucketed
sentence iterator, and the RNN checkpoint helpers."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell, FusedRNNCell,
                       SequentialRNNCell, BidirectionalCell, DropoutCell,
                       ResidualCell, ZoneoutCell, ModifierCell, RNNParams,
                       BaseConvRNNCell, ConvRNNCell, ConvLSTMCell,
                       ConvGRUCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint)

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell", "FusedRNNCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell", "ZoneoutCell", "ModifierCell", "RNNParams",
           "BaseConvRNNCell", "ConvRNNCell", "ConvLSTMCell", "ConvGRUCell",
           "BucketSentenceIter", "encode_sentences", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
