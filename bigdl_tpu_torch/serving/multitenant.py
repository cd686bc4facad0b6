"""Multi-tenant serving: several model snapshots on one card.

Counterpart of ``bigdl_tpu/serving/multitenant.py``. Each snapshot gets its
own :class:`~bigdl_tpu_torch.serving.engine.ServingEngine` (its own weights,
slot grid, cache and admission queue); their programs interleave on the
card without cross-engine scheduling. Engine knobs are per snapshot
(``per_model``): a latency-critical tenant can run ``admit_wait_ms=0``
beside a bulk tenant that batches.

A tenant may be a ``model.quantize(mode)`` snapshot (``nn/quantized.py``)
beside fp32 ones: the engine serves it unchanged (its private copy,
``swap_weights``, the captured prefill and decode programs).
"""

from __future__ import annotations

from typing import Optional

from bigdl_tpu_torch.obs import exporter as obs_exporter
from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.request import RequestHandle


class SnapshotServer:
    """Route requests to named model snapshots, each behind its own
    continuous-batching engine.

    ``models``: ``{name: model}``. ``engine_kwargs`` apply to every engine;
    ``per_model={name: {...}}`` overrides them for one. ``draft_models``:
    optional ``{name: draft}``, the named tenants serving speculatively.
    """

    def __init__(self, models: dict, max_len: int,
                 per_model: Optional[dict] = None,
                 draft_models: Optional[dict] = None, **engine_kwargs):
        if not models:
            raise ValueError("models must name at least one snapshot")
        per_model = per_model or {}
        draft_models = draft_models or {}
        unknown = set(per_model) - set(models)
        if unknown:
            raise ValueError(f"per_model names unknown snapshots: "
                             f"{sorted(unknown)}")
        unknown = set(draft_models) - set(models)
        if unknown:
            raise ValueError(f"draft_models names unknown snapshots: "
                             f"{sorted(unknown)}")
        self._engines: dict[str, ServingEngine] = {}
        for name, model in models.items():
            kw = dict(engine_kwargs)
            kw.update(per_model.get(name, {}))
            kw.setdefault("max_len", max_len)
            if name in draft_models:
                kw.setdefault("draft_model", draft_models[name])
            self._engines[name] = ServingEngine(model, name=name, **kw)
            # the tenant's rows on /metrics and /healthz exist before its
            # first request
            obs_exporter.register_engine(self._engines[name])

    @property
    def snapshots(self) -> tuple:
        return tuple(self._engines)

    def engine(self, snapshot: str) -> ServingEngine:
        return self._engines[snapshot]

    def _get(self, snapshot: str) -> ServingEngine:
        eng = self._engines.get(snapshot)
        if eng is None:
            raise KeyError(f"unknown snapshot {snapshot!r}; serving "
                           f"{sorted(self._engines)}")
        return eng

    def update_tenant(self, snapshot: str, params, version: int = 0,
                      timeout: float = 60.0):
        """Swap one tenant's weights in place
        (:meth:`ServingEngine.swap_weights`): its queue, grid and programs
        stay, no request is dropped, the other tenants are untouched.
        Returns the engine's :class:`SwapResult`."""
        return self._get(snapshot).swap_weights(params, version=version,
                                                timeout=timeout)

    def submit(self, snapshot: str, prompt, max_new_tokens: int,
               request_id=None, deadline_ms=None) -> RequestHandle:
        return self._get(snapshot).submit(prompt, max_new_tokens,
                                          request_id=request_id,
                                          deadline_ms=deadline_ms)

    def stats(self) -> dict:
        return {name: eng.stats() for name, eng in self._engines.items()}

    def shutdown(self, wait: bool = True, drain: bool = False) -> None:
        """Stop every engine before raising the first one's error: one
        tenant's :class:`EngineShutdownTimeout` leaves no other running."""
        errors = []
        for name, eng in self._engines.items():
            try:
                eng.shutdown(wait=wait, drain=drain)
            except Exception as e:  # noqa: BLE001 — stop the others first
                errors.append((name, e))
        if errors:
            raise errors[0][1]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
