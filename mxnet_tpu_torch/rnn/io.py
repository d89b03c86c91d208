"""Bucketed sequence iterators of the port (reference:
``mxnet_tpu/rnn/io.py``): ``encode_sentences`` and ``BucketSentenceIter``.

Given the same ``shuffle_seed`` the iterator yields the reference's
batches in the reference's order (one ``numpy.random.RandomState``). Its
batches are host arrays, as the reference's are; ``Module`` moves them to
its device.
"""
from __future__ import annotations

import numpy as _np

from ..context import cpu
from ..io import DataIter, DataBatch, DataDesc
from ..ndarray.ndarray import array as _array

__all__ = ["BucketSentenceIter", "encode_sentences"]


def nd_array(values):
    return _array(values, ctx=cpu())


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0, unknown_token=None):
    """Token lists -> id lists, building a vocab (reference: io.py:33)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token:
                        word = unknown_token
                    else:
                        raise ValueError("Unknown token %s" % word)
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Pads encoded sentences into length buckets; emits DataBatch with
    bucket_key for BucketingModule (reference: io.py:69)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", shuffle_seed=None):
        super().__init__(batch_size)
        if not buckets:
            counts = _np.bincount([len(s) for s in sentences])
            buckets = [i for i, j in enumerate(counts)
                       if j >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets.sort()
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = _np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = _np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        # keep empty buckets 2-D so the label shift in reset() stays valid
        self.data = [_np.asarray(i, dtype=dtype) if i
                     else _np.empty((0, blen), dtype=dtype)
                     for i, blen in zip(self.data, buckets)]
        if ndiscard:
            import logging
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.default_bucket_key = max(buckets)
        self._rng = _np.random.RandomState(shuffle_seed)

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.reset()

    @property
    def provide_data(self):
        shape = ((self.batch_size, self.default_bucket_key)
                 if self.layout == "NT"
                 else (self.default_bucket_key, self.batch_size))
        return [DataDesc(self.data_name, shape, layout=self.layout)]

    @property
    def provide_label(self):
        shape = ((self.batch_size, self.default_bucket_key)
                 if self.layout == "NT"
                 else (self.default_bucket_key, self.batch_size))
        return [DataDesc(self.label_name, shape, layout=self.layout)]

    def reset(self):
        self.curr_idx = 0
        # numpy permutation — random.Random.shuffle corrupts 2-D ndarrays
        # (its tuple-swap operates on row views)
        perm = self._rng.permutation(len(self.idx))
        self.idx = [self.idx[i] for i in perm]
        self.data = [buck[self._rng.permutation(len(buck))]
                     if len(buck) else buck for buck in self.data]
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = _np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(buck)
            self.ndlabel.append(label)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        if self.layout == "NT":
            data = self.nddata[i][j:j + self.batch_size]
            label = self.ndlabel[i][j:j + self.batch_size]
        else:
            data = self.nddata[i][j:j + self.batch_size].T
            label = self.ndlabel[i][j:j + self.batch_size].T
        return DataBatch([nd_array(data)], [nd_array(label)], pad=0,
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape,
                                                layout=self.layout)],
                         provide_label=[DataDesc(self.label_name, label.shape,
                                                 layout=self.layout)])
