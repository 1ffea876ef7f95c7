"""Train-step builder: microbatched gradient accumulation, clipping, AdamW,
optional int8 gradient compression (the counterpart of
``repro.train.loop``, on one device).

``make_train_step(model, opt_cfg)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``; with ``compress=True``,
``step(params, opt_state, ef, batch) -> (params, opt_state, ef,
metrics)``. ``params`` are the model's training masters
(``model.init_masters``) and are updated in place; ``metrics`` holds the
``loss``, ``grad_norm`` and ``lr`` as 0-d tensors on the device, read
without a host sync until the caller asks.
"""
from __future__ import annotations

import torch

from repro_torch.optim import adamw
from repro_torch.runtime import compress as gc


def _split_microbatches(batch: dict, m: int) -> list[dict]:
    """``batch`` as ``m`` microbatches along the leading axis, in order."""
    def sp(x):
        x = torch.as_tensor(x)
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch of {b} does not split into {m} microbatches")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))

    split = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(m)]


_leaves = adamw._leaves  # dict keys sorted, as jax.tree orders them


def _unflatten(tree: dict, it) -> dict:
    return {k: _unflatten(tree[k], it) if isinstance(tree[k], dict) else next(it) for k in sorted(tree)}


def _value_and_grad(model, params: dict, batch: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """The loss and the gradient of every master leaf; a leaf the loss never
    reads (hubert's ``embed``) gets zeros, as ``jax.grad`` gives it."""
    leaves = _leaves(params)
    with torch.enable_grad():
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]


def make_train_step(model, opt_cfg: adamw.AdamWConfig, compress: bool = False):
    """Returns step(params, opt_state, [ef_state,] batch) -> (..., metrics)."""

    def grads_of(params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        m = model.cfg.microbatches
        if m == 1:
            loss, grads = _value_and_grad(model, params, batch)
            return loss, _unflatten(params, iter(grads))
        acc_dtype = getattr(torch, model.cfg.grad_accum_dtype)
        loss_sum, g_sum = 0.0, [torch.zeros(p.shape, dtype=acc_dtype, device=p.device) for p in _leaves(params)]
        for mbatch in _split_microbatches(batch, m):  # the scan's order
            loss, g = _value_and_grad(model, params, mbatch)
            loss_sum = loss_sum + loss
            g_sum = [(a + b.to(acc_dtype)).to(acc_dtype) for a, b in zip(g_sum, g)]
        return loss_sum / m, _unflatten(params, iter([(g / m).to(acc_dtype) for g in g_sum]))

    if compress:

        def step(params, opt_state, ef, batch):
            loss, grads = grads_of(params, batch)
            grads, ef = gc.compress_grads(grads, ef)
            params, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state, params)
            return params, opt_state, ef, dict(metrics, loss=loss)

        return step

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, metrics = adamw.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return step
