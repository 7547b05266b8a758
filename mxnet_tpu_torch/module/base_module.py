"""BaseModule: the high-level train and evaluation loop.

Counterpart of ``mxnet_tpu/module/base_module.py`` (parity: reference
``base_module.py``: ``fit``, ``forward_backward``, ``fused_step``,
``score``, ``predict``, ``iter_predict``, ``save_params``/``load_params``).
The loop runs each batch through the subclass's
fused batch step when it can and phase-split (``forward_backward``,
``update``, ``update_metric``) otherwise, and never waits on the device
inside an epoch unless a callback reads the metric. Each batch records
the fit-phase spans (``telemetry.FIT_PHASE_SPANS``) under the causal
ids ``(epoch, nbatch)``. ``fit``'s fault-tolerance extensions are the
JAX package's (``mxnet_tpu/module/base_module.py:236-560``): a
``CheckpointManager`` that saves at each epoch end and on SIGTERM/SIGINT
mid-epoch, ``resume``, a monitor, and the divergence sentinel with its
``halt``/``skip``/``rollback`` policies. Elastic recovery (a peer lost
across processes) waits for ROADMAP Queue 1 item 4, second half.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from ..base import MXNetError
from .. import metric as _metric
from .. import telemetry
from ..model import BatchEndParam
from ..initializer import Uniform

# stable fallback reason codes -> what they mean: the JAX package's set
# (the port raises ``kvstore_dist``, ``kvstore_compression``,
# ``env_pin``, ``monitor``, ``inputs_need_grad``, ``no_trainable_params``
# and ``not_initialised``; the rest name JAX-side program conditions)
FUSED_FALLBACK_CODES = {
    "env_pin": "MXNET_MODULE_FUSED_STEP=0 pins the phase-split A/B leg",
    "monitor": "per-op monitor taps need the phase-split programs",
    "kvstore_dist": "dist_* kvstore push/pull crosses worker processes",
    "kvstore_compression": "gradient compression changes pushed values",
    "group2ctx": "grouped (group2ctx) programs run eagerly per segment",
    "no_fused_updater": "updater has no fused batch path",
    "inputs_need_grad": "data gradients are phase-split only",
    "optimizer_kernel": "optimizer has no pure SPMD batch kernel",
    "centered_rmsprop": "centered RMSProp state layout",
    "no_trainable_params": "nothing to update",
    "state_layout": "optimizer state layout not expressible as a kernel",
    "missing_input": "bound input missing from the executor arg dict",
    "unfed_graph_arg": "graph argument not fed by the fused step",
    "not_initialised": "module not fully initialised",
}


class FusedFallback(str):
    """Why one step ran phase-split: the message, with a stable ``code``
    (one of ``FUSED_FALLBACK_CODES``)."""
    __slots__ = ("code", "detail")

    def __new__(cls, code, message, detail=None):
        if code not in FUSED_FALLBACK_CODES:
            raise MXNetError("unknown fallback code %r" % code)
        self = str.__new__(cls, message)
        self.code = code
        self.detail = message if detail is None else detail
        return self


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


class BaseModule:
    """(parity: base_module.BaseModule)"""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- things subclasses implement --------------------------------------
    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    # -- composite ---------------------------------------------------------
    def forward_backward(self, data_batch):
        """(parity: base_module.forward_backward)"""
        self.forward(data_batch, is_train=True)
        self.backward()

    def _fused_batch_step(self, data_batch, eval_metric=None):
        """Run forward, backward, update and metric as one step and return
        True, or return False for the phase-split path (the base class
        always phase-splits)."""
        return False

    def _note_fused_fallback(self):
        """Account one phase-split step: count the fallback event in the
        telemetry registry (keyed by the stable ``FusedFallback.code``)
        and log it as a structured warning ONCE per module per code."""
        reason = getattr(self, "_fused_fallback_reason", None)
        if reason is None:
            return
        code = getattr(reason, "code", "unknown")
        telemetry.record_fallback(code)
        logged = self.__dict__.setdefault("_fused_fallback_logged", set())
        if code not in logged:
            logged.add(code)
            from .. import log as _log
            _log.get_logger("mxnet_tpu_torch.module").warning(
                "fused-step fallback code=%s: %s (detail: %s) — this "
                "module trains phase-split (see "
                "mx.mod.FUSED_FALLBACK_CODES)",
                code, str(reason), getattr(reason, "detail", str(reason)))

    def telemetry_snapshot(self):
        """The process-wide ``telemetry.snapshot()`` (dispatch counts,
        fused-fallback codes, transfer bytes, blocking host syncs, span
        p50/p95/p99, the program cards with their FLOPs and footprint,
        the online MFU estimate and the device-buffer ledger) plus this
        module's last fused-fallback reason/code. JSON-serializable end
        to end."""
        snap = telemetry.snapshot()
        reason = getattr(self, "_fused_fallback_reason", None)
        snap["fused_fallback_reason"] = None if reason is None \
            else str(reason)
        snap["fused_fallback_code"] = getattr(reason, "code", None)
        return snap

    def fused_step(self, data, label=None, eval_metric=None):
        """One whole training step — forward, backward, optimizer update
        and metric update — through the fused batch step when it can run
        (True) and phase-split otherwise (False); the ``Module.fit`` inner
        loop for manual training loops. ``data`` is a DataBatch or
        NDArray(s) with ``label`` beside."""
        from ..io import DataBatch
        if not isinstance(data, DataBatch):
            d = list(data) if isinstance(data, (list, tuple)) else [data]
            lab = None if label is None else (
                list(label) if isinstance(label, (list, tuple)) else [label])
            data = DataBatch(data=d, label=lab)
        if self._fused_batch_step(data, eval_metric):
            return True
        self.forward_backward(data)
        self.update()
        if eval_metric is not None:
            self.update_metric(eval_metric, data.label)
        return False

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """(parity: base_module.score)"""
        if not (self.binded and self.params_initialized):
            raise MXNetError("score: bind and init_params first")
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric,
                                      locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
            actual_num_batch += 1
        if score_end_callback:
            param = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                  eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` per batch, each output with
        the batch's ``pad`` rows trimmed (parity:
        base_module.iter_predict)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("iter_predict: bind and init_params first")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """The outputs over ``eval_data`` with each batch's ``pad`` rows
        trimmed (parity: base_module.predict): with ``merge_batches`` one
        array per output, concatenated on the device (the array itself
        for one output unless ``always_output_list``), else a list of
        per-batch output lists."""
        from ..ndarray import concatenate
        output_list = [outs for outs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return output_list
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        if any(len(out) != num_outputs for out in output_list):
            raise MXNetError("Cannot merge batches: different number of "
                             "outputs per batch")
        merged = [concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint=None,
            resume=None, divergence_check_every=0,
            divergence_policy="halt"):
        """Train (parity: base_module.fit — bind, init_params,
        init_optimizer, then per batch the fused step or forward_backward,
        update and update_metric), with the JAX package's extensions:

        - ``checkpoint``: a ``CheckpointManager`` (or a prefix) that saves
          at each epoch end and, with SIGTERM/SIGINT armed for the
          duration of ``fit``, after the batch in flight when a signal
          comes, then raises ``TrainingPreempted``;
        - ``resume``: True (from ``checkpoint``'s latest) or a manager or
          prefix: parameters, optimizer states and update counts, the
          generators; the batches already applied in the resumed epoch
          are drawn from the iterator and not computed. No checkpoint is
          a fresh start;
        - ``monitor``: installed on the executor (the step phase-splits);
        - ``divergence_check_every`` N: every N batches ``finite_check``;
          on a non-finite value ``divergence_policy`` ``halt`` raises
          ``DivergenceError``, ``skip`` counts and goes on, ``rollback``
          restores the latest checkpoint (halts without one)."""
        from ..checkpoint import CheckpointManager
        if num_epoch is None:
            raise MXNetError("fit: please specify number of epochs")
        if divergence_policy not in ("halt", "skip", "rollback"):
            raise MXNetError("divergence_policy must be halt|skip|rollback, "
                             "got %r" % (divergence_policy,))
        ckpt = CheckpointManager(checkpoint) if isinstance(checkpoint, str) \
            else checkpoint
        rmgr = None
        if resume is not None and resume is not False:
            rmgr = ckpt if resume is True else resume
            if isinstance(rmgr, str):
                rmgr = CheckpointManager(rmgr)
            if rmgr is None:
                raise MXNetError("fit(resume=True) needs checkpoint=")
        resume_meta = rmgr.latest() if rmgr is not None else None
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        skip_batches = 0
        if resume_meta is not None:
            rmgr.restore(self, resume_meta)
            begin_epoch = int(resume_meta["epoch"])
            skip_batches = int(resume_meta.get("nbatch", 0))
            self.logger.info("Resuming from checkpoint %s: epoch=%d "
                             "nbatch=%d", rmgr.prefix, begin_epoch,
                             skip_batches)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        if ckpt is not None:
            ckpt.clear_preempt()
            ckpt.arm_signals()
        try:
            self._fit_loop(train_data, eval_data, eval_metric,
                           validation_metric, epoch_end_callback,
                           batch_end_callback, eval_end_callback,
                           eval_batch_end_callback, monitor, begin_epoch,
                           num_epoch, skip_batches, ckpt,
                           divergence_check_every, divergence_policy)
        finally:
            if ckpt is not None:
                ckpt.disarm_signals()

    def _fit_loop(self, train_data, eval_data, eval_metric,
                  validation_metric, epoch_end_callback, batch_end_callback,
                  eval_end_callback, eval_batch_end_callback, monitor,
                  begin_epoch, num_epoch, skip_batches, ckpt,
                  divergence_check_every, divergence_policy):
        """The epochs of ``fit`` (parity: base_module._fit_loop)."""
        train_data.reset()
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            if epoch == begin_epoch and skip_batches:
                # mid-epoch resume: these batches' updates are in the
                # checkpoint; draw them without compute so the rest of
                # the epoch sees the data the interrupted run would have
                for _ in range(skip_batches):
                    try:
                        next(data_iter)
                    except StopIteration:
                        break
                nbatch = skip_batches
            try:
                next_data_batch = next(data_iter)
            except StopIteration:
                end_of_batch = True
            while not end_of_batch:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                # the causal() scope stamps (epoch, nbatch) on every span
                # this batch records (fit_batch, feed, step, opt_update,
                # ...); the next batch is fetched inside it, as in the
                # JAX package, while this one runs on the device
                with telemetry.causal(epoch=epoch, nbatch=nbatch), \
                        telemetry.span("fit_batch"):
                    fused = self._fused_batch_step(data_batch, eval_metric)
                    if not fused:
                        self._note_fused_fallback()
                        self.forward_backward(data_batch)
                        self.update()
                    try:
                        next_data_batch = next(data_iter)
                    except StopIteration:
                        end_of_batch = True
                    if not fused:
                        self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if divergence_check_every > 0 \
                        and (nbatch + 1) % divergence_check_every == 0 \
                        and not self.finite_check():
                    self._handle_divergence(divergence_policy, ckpt, epoch,
                                            nbatch)
                if batch_end_callback is not None:
                    with telemetry.span("callbacks"):
                        param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                              eval_metric=eval_metric,
                                              locals=locals())
                        for cb in _as_list(batch_end_callback):
                            cb(param)
                nbatch += 1
                # the preemption point: nbatch batches of this epoch are
                # applied, so (epoch, nbatch) resumes exactly here
                if ckpt is not None and ckpt.preempt_requested:
                    self._preempted(ckpt, epoch, nbatch)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                with telemetry.span("epoch_sync"):
                    arg_p, aux_p = self.get_params()
                with telemetry.span("callbacks"):
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_p, aux_p)
                # the copies must not live through the next epoch
                del arg_p, aux_p
            if ckpt is not None:
                # epoch complete: the resume point is the next epoch
                ckpt.save(self, epoch + 1, 0)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _preempted(self, ckpt, epoch, nbatch):
        """Save at ``(epoch, nbatch)``, count it, write a postmortem and
        raise ``TrainingPreempted``."""
        from ..checkpoint import TrainingPreempted
        from .. import flight as _flight
        source = ckpt.preempt_requested
        ckpt.save(self, epoch, nbatch)
        telemetry.counter_inc("training.preempted")
        telemetry.record_event("training.preempted", source=source,
                               epoch=epoch, nbatch=nbatch)
        _flight.postmortem("training_preempted",
                           extra={"source": source, "epoch": epoch,
                                  "nbatch": nbatch, "prefix": ckpt.prefix})
        raise TrainingPreempted(
            "training preempted by %s at epoch %d batch %d; checkpoint "
            "saved under %r — fit(resume=...) continues from here"
            % (source, epoch, nbatch, ckpt.prefix),
            epoch=epoch, nbatch=nbatch, prefix=ckpt.prefix)

    def finite_check(self):
        """True when the last step's outputs are all finite (the base
        class folds the output heads on the host; ``Module`` folds
        outputs, gradients and parameters on the device)."""
        for o in self.get_outputs():
            a = o.asnumpy()
            if np.issubdtype(a.dtype, np.floating) \
                    and not np.isfinite(a).all():
                return False
        return True

    def _handle_divergence(self, policy, ckpt, epoch, nbatch):
        """The divergence policy after ``finite_check()`` failed (parity:
        base_module._handle_divergence): count, then skip, roll back or
        halt."""
        from ..checkpoint import DivergenceError
        from .. import flight as _flight
        from .. import log as _log
        telemetry.counter_inc("divergence.detected")
        telemetry.record_event("divergence.detected", epoch=epoch,
                               nbatch=nbatch, policy=policy)
        where = "epoch %d batch %d" % (epoch, nbatch)
        logger = _log.get_logger("mxnet_tpu_torch.module")
        if policy == "skip":
            telemetry.counter_inc("divergence.skipped")
            logger.warning("divergence sentinel: non-finite loss/params at "
                           "%s — policy=skip, continuing", where)
            return
        if policy == "rollback":
            if ckpt is not None and ckpt.latest() is not None:
                meta = ckpt.restore(self)
                telemetry.counter_inc("divergence.rollback")
                logger.warning("divergence sentinel: non-finite "
                               "loss/params at %s — rolled back to "
                               "checkpoint epoch=%d nbatch=%d", where,
                               meta["epoch"], meta.get("nbatch", 0))
                return
            logger.warning("divergence sentinel: policy=rollback but no "
                           "checkpoint to roll back to — halting")
        err = DivergenceError("divergence sentinel: non-finite loss/params "
                              "at %s (policy=%s)" % (where, policy))
        _flight.postmortem("divergence", exc=err,
                           extra={"epoch": epoch, "nbatch": nbatch,
                                  "policy": policy})
        raise err

    def install_monitor(self, mon):
        """(parity: base_module.install_monitor) nothing to tap here."""

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """(parity: base_module.prepare) nothing to prepare without
        sparse storage."""

    def get_states(self, merge_multi_context=True):
        """States of stateful modules: none here (parity:
        base_module.get_states)."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("get_states: bind and init_params first")
        return []

    def set_states(self, states=None, value=None):
        """(parity: base_module.set_states) nothing to set in a module
        without states."""
        if not (self.binded and self.params_initialized):
            raise MXNetError("set_states: bind and init_params first")
        if states or value:
            raise MXNetError("set_states: this module has no states")

    def save_params(self, fname):
        """The parameters and aux states in one ``nd.save`` file with
        ``arg:``/``aux:`` keys (parity: base_module.save_params)."""
        from ..ndarray import save
        arg_params, aux_params = self.get_params()
        blob = {("arg:%s" % k): v for k, v in arg_params.items()}
        blob.update({("aux:%s" % k): v for k, v in aux_params.items()})
        save(fname, blob)

    def load_params(self, fname):
        """Parameters written by ``save_params`` of either package (read
        to the host, then copied into the bound arrays)."""
        from ..context import cpu
        from ..ndarray import load
        arg_params, aux_params = {}, {}
        for k, value in load(fname, ctx=cpu()).items():
            kind, name = k.split(":", 1)
            if kind == "arg":
                arg_params[name] = value
            elif kind == "aux":
                aux_params[name] = value
            else:
                raise MXNetError("Invalid param file: " + fname)
        self.set_params(arg_params, aux_params)

    @property
    def symbol(self):
        return self._symbol
