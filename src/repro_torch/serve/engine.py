"""Latency-first serving engine of the port: batched prefill/decode with
per-request state, straggler deadlines, and optional SLSH-kNN-LM
augmentation.

Counterpart of ``repro.serve.engine``. Requests are micro-batched up to
``max_batch``: each is prefilled alone, their caches are stacked, and the
batch decodes greedily one step at a time, each step one forward pass of
the model on the card. The kNN-LM hook retrieves from a
``repro_torch.dslsh`` index over hidden states at every step; with
``degrade`` levels on a routed index the engine's latency budget caps the
cells it probes. An ``obs`` bundle records a ``serve.batch`` span a
micro-batch and the per-request latency histogram and the request and
timeout counters, under the JAX package's names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.obs import clock


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # (prompt_len,)
    max_new: int = 16
    deadline_s: float = float("inf")  # straggler deadline (from submission)
    submitted_at: float = 0.0  # monotonic; 0.0 = stamped at serve() entry
    result: list = dataclasses.field(default_factory=list)
    done: bool = False
    timed_out: bool = False
    latency_s: float = 0.0


class ServeEngine:
    """Batched greedy decoding over a fixed-capacity slot table.

    ``model`` is a ``repro_torch.models.api.build_model`` handle and
    ``params`` the model it initialised (or carried across). ``obs``, an
    ``repro_torch.obs.Obs``, is made the active bundle while ``serve``
    runs (a hook's ``get_active`` finds it)."""

    def __init__(
        self,
        model,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 512,
        logits_hook: Callable[..., torch.Tensor] | None = None,
        obs: obs_mod.Obs | None = None,
    ):
        self.model = model
        self.params = params
        self.obs = obs
        self.max_batch = max_batch
        self.max_len = max_len + model.cfg.meta_tokens
        self.logits_hook = logits_hook  # e.g. SLSH-kNN-LM interpolation
        # deadline-aware hooks opt in by carrying ``accepts_budget = True``
        # (make_knn_lm_hook sets it) and then receive (logits, carrier,
        # budget_s); any other hook keeps the two-argument call
        self._hook_takes_budget = bool(getattr(logits_hook, "accepts_budget", False))

    def _prefill_one(self, req: Request):
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32))[None, :]
        return self.model.prefill(self.params, {"tokens": toks}, self.max_len)

    def serve(self, requests: list[Request]) -> list[Request]:
        """Prefill each request, then decode the active batch step by step
        (greedy).

        A request whose ``deadline_s`` expires mid-decode is finalized at
        once with the tokens produced so far (``timed_out`` set,
        ``latency_s`` at expiry); the batch keeps decoding for the others
        and stops once all are finalized. Deadlines count from
        ``submitted_at`` (stamped here when the caller left it 0.0) on the
        monotonic clock, so time queued behind earlier micro-batches counts
        and a wall-clock jump never expires a deadline. With an obs bundle
        each micro-batch records a ``serve.batch`` span and every finalized
        request feeds the latency histogram and the request and timeout
        counters."""
        t_in = clock.monotonic()
        for r in requests:
            if not r.submitted_at:
                r.submitted_at = t_in
        ob = self.obs
        with ob.activate() if ob is not None else contextlib.nullcontext():
            for batch_start in range(0, len(requests), self.max_batch):
                group = requests[batch_start : batch_start + self.max_batch]
                with self._span("serve.batch", requests=len(group)):
                    self._serve_group(group)
        return requests

    def _span(self, name: str, **args):
        if self.obs is None:
            return obs_mod.NULL_SPAN
        return self.obs.span(name, **args)

    def _finalize(self, r: Request, elapsed: float, timed_out: bool = False):
        r.done = True
        r.timed_out = timed_out
        r.latency_s = elapsed
        ob = self.obs
        if ob is not None and ob.metrics is not None:
            m = ob.metrics
            m.histogram(
                "dslsh_serve_request_latency_seconds",
                "per-request serve latency (submission -> finalize; queued time counts)",
            ).observe(elapsed)
            m.counter("dslsh_serve_requests_total", "requests finalized").inc()
            if timed_out:
                m.counter("dslsh_serve_timeouts_total", "requests finalized early by their straggler deadline").inc()

    def _serve_group(self, group: list[Request]) -> None:
        caches, logits_list = [], []
        for r in group:
            lg, ch = self._prefill_one(r)
            caches.append(ch)
            logits_list.append(lg)
        cache = _stack_caches(caches)
        del caches
        logits = torch.cat(logits_list, dim=0)
        steps = max(r.max_new for r in group)
        for _ in range(steps):
            now = clock.monotonic()
            for r in group:
                # completion first: a request with all its tokens can no
                # longer time out; elapsed counts from submission
                if not r.done and len(r.result) >= r.max_new:
                    self._finalize(r, now - r.submitted_at)
                if not r.done and now - r.submitted_at > r.deadline_s:
                    self._finalize(r, now - r.submitted_at, timed_out=True)
            if all(r.done for r in group):
                break
            if self.logits_hook is not None:
                if self._hook_takes_budget:
                    # the batch's tightest remaining latency budget
                    budget = min(
                        (r.deadline_s - (now - r.submitted_at) for r in group if not r.done),
                        default=float("inf"),
                    )
                    logits = self.logits_hook(logits, cache, budget)
                else:
                    logits = self.logits_hook(logits, cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            host = tok.tolist()
            for i, r in enumerate(group):
                if not r.done and len(r.result) < r.max_new:
                    r.result.append(int(host[i]))
            logits, cache = self.model.decode_step(self.params, cache, tok[:, None])
        t_end = clock.monotonic()
        for r in group:
            if not r.done:
                self._finalize(r, t_end - r.submitted_at)


def _stack_caches(caches: list):
    """The B=1 caches stacked along the batch axis, tree-wise (hymba's is
    nested): a leaf of one dimension (``len``) on axis 0, any other (a
    stacked ``(L, B, ...)`` leaf) on axis 1, as the JAX engine's
    ``_batch_axis_guess`` does."""
    if isinstance(caches[0], dict):
        return {name: _stack_caches([c[name] for c in caches]) for name in caches[0]}
    return torch.cat(caches, dim=0 if caches[0].dim() == 1 else 1)


def make_knn_lm_hook(
    index,
    next_tokens=None,
    *legacy_args,
    hidden_fn: Callable[[Any], torch.Tensor],
    vocab: int,
    lmbda: float = 0.25,
    temperature: float = 1.0,
    plan=None,
    degrade=None,
) -> Callable[..., torch.Tensor]:
    """SLSH-kNN-LM logits hook: interpolate the LM's distribution with one
    over the next tokens of the K nearest datastore hidden states
    (Khandelwal et al., with DSLSH retrieval).

    ``index`` is a ``repro_torch.dslsh`` :class:`~repro_torch.api.Index`
    over the hidden-state keys and ``next_tokens`` each entry's label.
    Retrieval is ``index.query(hq, max_cells=...)``, so the backend, the
    ``c_comp`` budget and the deployment ride on the handle.
    ``hidden_fn(carrier) -> (B, d)`` gives the query hidden states from the
    hook's second argument (``ServeEngine`` passes its decode cache, which
    holds no hidden states, so ``hidden_fn`` then derives them from state
    it closes over).

    ``degrade`` declares deadline-degradation levels ``((min_budget_s,
    max_cells), ...)`` (a routed index only): the engine hands the hook the
    batch's tightest remaining latency budget every step, and
    ``routing.degrade_max_cells`` maps it to a cap on the cells probed per
    query, counted in ``dslsh_serve_degraded_total{max_cells=...}`` of the
    active obs bundle (approximate retrieval, never applied without an
    explicit ``degrade``).

    The deprecated positional form ``make_knn_lm_hook(raw_index, points,
    next_tokens, cfg, grid, ...)`` (``raw_index`` the cell list of
    ``core.distributed.simulate_build``) warns with ``DeprecationWarning``
    and wraps the raw index in a grid handle (``api.wrap_grid``, routed
    when ``plan`` is given), as the JAX package's does."""
    from repro_torch import api
    from repro_torch.core import routing

    if not isinstance(index, api.Index):
        # legacy call: (index, datastore_points, next_tokens, slsh_cfg, grid)
        warnings.warn(
            "make_knn_lm_hook(raw_index, points, next_tokens, cfg, grid) is deprecated: pass a"
            " repro_torch.dslsh Index (dslsh.build(..., deploy=dslsh.grid(...))) and the next-token labels",
            DeprecationWarning,
            stacklevel=2,
        )
        datastore_points = next_tokens
        next_tokens, slsh_cfg, grid_ = legacy_args
        index = api.wrap_grid(index, datastore_points, slsh_cfg, grid_, plan=plan)
    else:
        if legacy_args or plan is not None:
            raise ValueError(
                "with a repro_torch.dslsh Index, routing lives on the handle — build it with"
                " dslsh.grid(..., routed=True) instead of passing plan/positional legacy arguments"
            )
        if next_tokens is None:
            raise ValueError(
                "make_knn_lm_hook needs the datastore's next-token labels:"
                " make_knn_lm_hook(index, next_tokens, hidden_fn=..., vocab=...)"
            )
    if degrade is not None and index.plan is None:
        raise ValueError(
            "degrade levels require a routed deployment — build the index with dslsh.grid(..., routed=True)"
        )
    if not isinstance(next_tokens, torch.Tensor):
        next_tokens = torch.from_numpy(np.array(next_tokens))
    labels = next_tokens.to(index.device, torch.int64)

    def hook(logits: torch.Tensor, carrier, budget_s: float = float("inf")) -> torch.Tensor:
        hq = hidden_fn(carrier)  # (B, d)
        max_cells = routing.degrade_max_cells(budget_s, degrade) if degrade else None
        if max_cells is not None:
            ob = obs_mod.get_active()
            if ob is not None and ob.metrics is not None:
                ob.metrics.counter(
                    "dslsh_serve_degraded_total",
                    "retrieval steps the deadline budget degraded to a max_cells cap (§10 latency-first mode)",
                ).labels(max_cells=str(max_cells)).inc()
        res = index.query(hq, max_cells=max_cells)
        return knn_interpolate(logits, res.knn_idx, res.knn_dist, labels, vocab, lmbda, temperature)

    hook.accepts_budget = True  # opt into the engine's deadline budget
    return hook


def knn_interpolate(
    logits: torch.Tensor,  # (B, V) base LM logits
    knn_idx: torch.Tensor,  # (B, K) datastore neighbours (-1 pad)
    knn_dist: torch.Tensor,  # (B, K)
    next_tokens: torch.Tensor,  # (N,) datastore next-token labels
    vocab: int,
    lmbda: float = 0.25,
    temperature: float = 1.0,
) -> torch.Tensor:
    """log p, p = (1-l)*softmax(logits) + l*knn_dist-weighted next-token
    histogram (the base distribution where a row has no neighbour)."""
    valid = knn_idx >= 0
    w = torch.softmax(
        torch.where(valid, -knn_dist.float() / temperature, float("-inf")), dim=-1
    )
    w = torch.where(valid, w, 0.0)
    next_tokens = next_tokens.to(knn_idx.device).long()
    toks = next_tokens[knn_idx.long().clamp(0, next_tokens.shape[0] - 1)]  # (B, K)
    knn_p = torch.zeros((knn_idx.shape[0], vocab), dtype=torch.float32, device=knn_idx.device)
    knn_p.scatter_add_(1, toks, w)
    base_p = torch.softmax(logits.float(), dim=-1)
    any_knn = valid.any(dim=-1, keepdim=True)
    p = torch.where(any_knn, (1 - lmbda) * base_p + lmbda * knn_p, base_p)
    return torch.log(p + 1e-20)
