"""BaseModule of the port: ``fit``, ``score``, ``predict``,
``iter_predict`` and ``forward_backward`` (reference:
``mxnet_tpu/module/base_module.py`` L1-491).

``fit`` is the reference's epoch loop with its log lines
(``Epoch[%d] Train-%s=%f``, ``Time cost``, ``Validation-%s=%f``): each
batch runs ``forward_backward`` and ``update``, takes the next batch
while the step's device work is in flight, updates the metric and calls
the batch-end callbacks; each epoch ends with the params brought to the
module's arrays, the epoch-end callbacks and ``score`` on ``eval_data``.
On the fused path the train iterator is wrapped in a device prefetch
(``Module._wrap_train_iter``), torn down when the fit ends. A supervisor
(``supervisor=``, or ``MXNET_TPU_TRAIN_SUPERVISE=1`` when it is None;
``False`` forces it off) runs the whole fit through
``resilience.TrainingSupervisor.run_fit`` (reference L167-240), and a
supervised epoch observes every step's verdict before its params are
read. ``monitor=`` installs a ``monitor.Monitor`` on the executors
(``install_monitor``), ticked before each batch and printed after its
metric update, as the reference's loop does (L211, L313-327).
``checkpoint_manager=`` is not yet ported (ROADMAP A8).
"""
from __future__ import annotations

import logging
import time

from ..base import MXNetError
from .. import metric as metric_mod
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith("_weight")
                      and not arg.endswith("_bias")
                      and not arg.endswith("_gamma")
                      and not arg.endswith("_beta")]
        msg = ("\033[91mYou created Module with Module(..., %s_names=%s) but "
               "input with name '%s' is not found in symbol.list_arguments()"
               ". Did you mean one of:\n\t%s\033[0m"
               % (typename, str(names), name, "\n\t".join(candidates)))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0
        self._supervisor = None

    # ------------------------------------------------------------------
    # high-level API
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _eval_batches(self, eval_data, num_batch, reset, sparse_row_id_fn):
        """Inference-mode sweep shared by score/predict/iter_predict:
        yields (index, batch) after each batch's forward."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for i, batch in enumerate(eval_data):
            if i == num_batch:  # num_batch=None never stops early
                return
            self.prepare(batch, sparse_row_id_fn=sparse_row_id_fn)
            self.forward(batch, is_train=False)
            yield i, batch

    def _unpadded_outputs(self, batch, copy=False):
        """The outputs without the batch's padding rows."""
        n_pad = batch.pad or 0
        outs = [o[:o.shape[0] - n_pad] for o in self.get_outputs()]
        return [o.copy() for o in outs] if copy else outs

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """The metric over ``eval_data`` in inference mode."""
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch in self._eval_batches(eval_data, num_batch, reset,
                                                sparse_row_id_fn):
            self.update_metric(eval_metric, batch.label)
            # locals() is part of the BatchEndParam contract; these are the
            # reference's names for callbacks that read them
            eval_batch = batch  # noqa: F841
            actual_num_batch = seen  # noqa: F841
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            seen += 1
        if score_end_callback:
            actual_num_batch = seen  # noqa: F841
            params = BatchEndParam(epoch=epoch, nbatch=seen,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True,
                     sparse_row_id_fn=None):
        """Lazy per-batch (outputs, index, batch)."""
        for nbatch, batch in self._eval_batches(eval_data, num_batch, reset,
                                                sparse_row_id_fn):
            yield (self._unpadded_outputs(batch), nbatch, batch)

    @staticmethod
    def _merge_predict_outputs(per_batch, merge_batches, always_output_list):
        if not per_batch or not merge_batches:
            return per_batch
        if len({len(outs) for outs in per_batch}) != 1:
            raise ValueError("Cannot merge batches: output count varies "
                             "across mini-batches (bucketing?)")
        from ..ndarray.ndarray import concatenate
        merged = [concatenate(list(column)) for column in zip(*per_batch)]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Inference-mode outputs over ``eval_data``, by default
        concatenated across batches."""
        per_batch = [self._unpadded_outputs(batch, copy=True)
                     for _, batch in self._eval_batches(
                         eval_data, num_batch, reset, sparse_row_id_fn)]
        return self._merge_predict_outputs(per_batch, merge_batches,
                                           always_output_list)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint_manager=None,
            supervisor=None):
        """Train ``num_epoch - begin_epoch`` epochs over ``train_data``
        (reference: base_module.py fit). ``supervisor`` (a
        ``resilience.TrainingSupervisor``) wraps the whole fit: NaN/Inf
        steps skipped with dynamic loss scaling, stall detection and
        bounded restarts; None consults ``MXNET_TPU_TRAIN_SUPERVISE`` once,
        False forces supervision off."""
        assert num_epoch is not None, "please specify number of epochs"
        if supervisor is None:
            from ..resilience.supervisor import supervisor_from_env
            supervisor = supervisor_from_env(checkpoint_manager)
        if supervisor:
            return supervisor.run_fit(self, dict(
                train_data=train_data, eval_data=eval_data,
                eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=optimizer, optimizer_params=optimizer_params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_rebind=force_rebind, force_init=force_init,
                begin_epoch=begin_epoch, num_epoch=num_epoch,
                validation_metric=validation_metric, monitor=monitor,
                sparse_row_id_fn=sparse_row_id_fn,
                checkpoint_manager=checkpoint_manager))
        if checkpoint_manager is not None:
            raise MXNetError("fit(checkpoint_manager=...) is not yet ported "
                             "(ROADMAP A8)")

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        # stage the next batch on the device while the current step runs
        # (the fused path; MXNET_DEVICE_PREFETCH=0 opts out)
        user_train_data = train_data
        train_data = self._wrap_train_iter(train_data)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, epoch_end_callback,
                             batch_end_callback, eval_end_callback,
                             eval_batch_end_callback, begin_epoch, num_epoch,
                             monitor, sparse_row_id_fn)
        finally:
            # a wrapper this fit made stops its stager, also when the fit
            # unwinds (a supervisor's retry makes a fresh one)
            if train_data is not user_train_data:
                train_data._shutdown()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, epoch_end_callback,
                    batch_end_callback, eval_end_callback,
                    eval_batch_end_callback, begin_epoch, num_epoch,
                    monitor, sparse_row_id_fn):
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            source = iter(train_data)
            batch = next(source)
            nbatch, last, epoch_values = 0, False, []
            while not last:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(batch)
                self.update()
                # take the next batch while this step's device work is in
                # flight
                try:
                    upcoming = next(source)
                    self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
                except StopIteration:
                    upcoming, last = None, True
                self.update_metric(eval_metric, batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if last:
                    # before the batch callbacks: Speedometer resets the
                    # metric, and the epoch line reports the whole epoch
                    epoch_values = eval_metric.get_name_value()
                if batch_end_callback is not None:
                    cb_params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(cb_params)
                nbatch += 1
                batch = upcoming

            for name, val in epoch_values:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            # a supervised fit observes every step's verdict first
            self._drain_inflight_flags()
            # the params into the module's arrays once an epoch, so the
            # epoch callbacks see the trained values
            arg_snapshot, aux_snapshot = self.get_params()
            self.set_params(arg_snapshot, aux_snapshot)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_snapshot, aux_snapshot)

            if eval_data is not None:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)

            train_data.reset()

    def _wrap_train_iter(self, train_data):
        """The iterator ``fit`` trains on (``Module`` wraps it in a device
        prefetch on the fused path)."""
        return train_data

    def _drain_inflight_flags(self):
        """Observe every dispatched step's verdict (``Module``, supervised
        fits)."""

    # ------------------------------------------------------------------
    # symbol/params accessors
    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        from ..model import save_params as _save
        arg_params, aux_params = self.get_params()
        _save(fname, arg_params, aux_params)

    def load_params(self, fname):
        from ..model import load_params as _load
        arg_params, aux_params = _load(fname)
        self.set_params(arg_params, aux_params)

    def install_monitor(self, mon):
        raise NotImplementedError

    def prepare(self, data_batch, sparse_row_id_fn=None):
        if sparse_row_id_fn is not None:
            raise MXNetError("prepare(sparse_row_id_fn=...) is not yet "
                             "ported (sparse storage, ROADMAP A9)")
