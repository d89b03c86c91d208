"""BucketingModule of the port: variable-length training with one
``Module`` a bucket (reference: ``mxnet_tpu/module/bucketing_module.py``).

``sym_gen(bucket_key)`` gives each bucket's symbol; the bucket modules
share the parameters (synced on each switch) and one optimizer, kvstore
and updater, so optimizer state survives a switch. Under
``kvstore='tpu_sync'`` only the module whose ``init_optimizer`` ran (the
default bucket's, in ``fit``) builds the fused step (kernel #7); the
other buckets update through the shared per-parameter updater, with
optimizer state of their own, exactly as the reference does (ROADMAP
§C). On the card each bucket's executors run its own shapes.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names or []
        self._state_names = state_names or []
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None
        self._grad_req = None
        self._params_dirty = False

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        _, data_names, _ = self._call_sym_gen(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        symbol, _, _ = self._call_sym_gen(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def _call_sym_gen(self, key):
        res = self._sym_gen(key)
        if len(res) != 3:
            raise MXNetError("sym_gen must return (symbol, data_names, "
                             "label_names)")
        return res

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        self._curr_module._params_dirty = self._params_dirty
        params = self._curr_module.get_params()
        self._params_dirty = False
        return params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self.params_initialized = True
        self._params_dirty = False

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        assert self.binded
        self._curr_module.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self.params_initialized = True
        self._params_dirty = False

    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Binds the default bucket (reference: bucketing_module.py bind)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if force_rebind:
            self._reset_bind()

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

        symbol, data_names, label_names = self._call_sym_gen(
            self._default_bucket_key)
        module = Module(symbol, data_names, label_names, logger=self.logger,
                        context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        group2ctxs=self._group2ctxs,
                        compression_params=self._compression_params)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def _ensure_bucket(self, bucket_key, data_shapes, label_shapes):
        """Create + bind a bucket's Module if it doesn't exist yet."""
        if bucket_key in self._buckets:
            return
        symbol, data_names, label_names = self._call_sym_gen(bucket_key)
        module = Module(symbol, data_names, label_names,
                        logger=self.logger, context=self._context,
                        work_load_list=self._work_load_list,
                        fixed_param_names=self._fixed_param_names,
                        state_names=self._state_names,
                        group2ctxs=self._group2ctxs,
                        compression_params=self._compression_params)
        module.bind(data_shapes, label_shapes, self.for_training,
                    self.inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=self._grad_req)
        if self._monitor is not None:
            module.install_monitor(self._monitor)
        self._buckets[bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Switch executors; create + param-sync on first use
        (reference: bucketing_module.py switch_bucket)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key == self._curr_bucket_key:
            return
        self._ensure_bucket(bucket_key, data_shapes, label_shapes)
        target = self._buckets[bucket_key]
        if self.params_initialized:
            # sync authoritative params from the active bucket
            arg_params, aux_params = self.get_params()
            target.set_params(arg_params, aux_params, allow_missing=False,
                              force_init=True)
            # share optimizer machinery so state survives the switch
            if self.optimizer_initialized:
                src = self._curr_module
                target._optimizer = src._optimizer
                target._kvstore = src._kvstore
                target._update_on_kvstore = src._update_on_kvstore
                target._updater = src._updater
                target.optimizer_initialized = True
        self._curr_module = target
        self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod._optimizer = self._curr_module._optimizer
                mod._kvstore = self._curr_module._kvstore
                mod._update_on_kvstore = self._curr_module._update_on_kvstore
                mod._updater = self._curr_module._updater
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Binds the next batch's bucket without switching to it: the
        current bucket's executors stay live for a pending
        ``get_outputs``/``update_metric``, and the parameters are synced
        once, in ``forward``'s switch."""
        assert self.binded and self.params_initialized
        bucket_key = getattr(data_batch, "bucket_key",
                             self._default_bucket_key)
        self._ensure_bucket(bucket_key, data_batch.provide_data,
                            data_batch.provide_label)
        self._buckets[bucket_key].prepare(data_batch,
                                          sparse_row_id_fn=sparse_row_id_fn)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        bucket_key = getattr(data_batch, "bucket_key",
                             self._default_bucket_key)
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert (self.binded and self.params_initialized
                and self.optimizer_initialized)
        self._params_dirty = True
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def save_optimizer_states(self, fname):
        self._curr_module.save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        self._curr_module.load_optimizer_states(fname)
