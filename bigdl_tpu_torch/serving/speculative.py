"""Greedy speculative decoding: a draft proposes, the target verifies in ONE
chunk.

Counterpart of ``bigdl_tpu/serving/speculative.py``. Plain greedy decode
pays one target forward a token. A small draft model guesses the next
``k`` tokens cheaply; the target checks all ``k`` in one chunked forward
and keeps the longest correct prefix. The output is plain greedy's at any
acceptance rate: every emitted token is a proposal the target's own argmax
agreed with, or the target's argmax itself.

- **Propose**: the draft takes ``cur, d1, …, dk`` (k+1 single-token steps;
  the last output is dropped), so its cache holds every token a full
  accept keeps and the rewind below is valid at any ``j``.
- **Verify**: the target runs the chunk ``[cur, d1 … dk]`` as one t=k+1
  cached step; position ``i``'s argmax ``g_i`` is the greedy token after
  ``… cur d1 … d_i`` (the chunked-prefill == full-forward invariant).
- **Accept**: ``j`` = the leading positions where ``g_i == d_{i+1}``
  (``cumprod(match).sum``); emit ``d1 … d_j`` and the correction ``g_j``,
  1..k+1 tokens a round.
- **Rewind**: both caches advanced k+1 positions and keep ``1 + j``, so
  every position counter steps back ``k - j``, per row, inside the step.

Both step functions run on caches that the caller owns and updates in place
(``nn.incremental``, ``serving/paged_cache.py``), so the serving engine
captures each as one program (``serving/engine.py``: the spec prefill
takes the prefill's key per bucket, the spec step the decode tick's).
:class:`SpeculativeDecoder` is the standalone offline form.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.abstractnn import evaluating
from bigdl_tpu_torch.nn.incremental import (
    install_decode_cache, rewind_decode_positions,
)
from bigdl_tpu_torch.utils.device import require_on


def _env_spec_tokens(default: int = 4) -> int:
    return int(os.environ.get("BIGDL_SPEC_TOKENS", default))


def build_spec_prefill(model, draft):
    """Fused context prefill: one target forward and one draft forward of
    the same tokens, each filling its own cache in place. Returns
    ``run(state, state_d, tokens (N, L)) -> target log-probs (N, L, V)``."""
    def run(state, state_d, tokens):
        logp, _ = model.run(tokens, state)
        draft.run(tokens, state_d)
        return logp

    return run


def build_spec_step(model, draft, k: int):
    """One draft-propose / chunk-verify / accept / rewind round over a
    per-row batch. Returns ``run(state, state_d, tok (S,) long) -> (props
    (S, k), greedy (S, k+1), n_acc (S,), ok (S,) bool)``: row ``r`` emits
    ``props[r, :n_acc[r]]`` and then ``greedy[r, n_acc[r]]``, and both
    states are rewound to the accepted depth in place. Nothing is read on
    the host, so the round captures as one program."""
    if k < 1:
        raise ValueError(f"spec_tokens must be >= 1, got {k}")

    def run(state, state_d, tok):
        t = tok
        props = []
        for _ in range(k + 1):
            logp, _ = draft.run(t[:, None], state_d)
            t = logp[:, 0].argmax(-1)
            props.append(t)
        props = torch.stack(props[:k], dim=1)                   # (S, k)
        chunk = torch.cat([tok[:, None], props], dim=1)         # (S, k+1)
        logp, _ = model.run(chunk, state)
        ok = torch.isfinite(logp).all(dim=2).all(dim=1)         # (S,)
        greedy = logp.argmax(-1)                                # (S, k+1)
        match = (greedy[:, :k] == props).long()
        n_acc = match.cumprod(dim=1).sum(dim=1)                 # (S,) 0..k
        back = k - n_acc
        rewind_decode_positions(state, back)
        rewind_decode_positions(state_d, back)
        return props, greedy, n_acc, ok

    return run


class SpeculativeDecoder:
    """Standalone (offline) speculative greedy decode of a batch of
    same-length prompts.

    ``model`` is the target, ``draft`` the proposer (any cached-decode
    causal LM over the same vocabulary; the target itself pins acceptance
    at 1). ``spec_tokens`` is k (``BIGDL_SPEC_TOKENS``, default 4).
    ``device`` defaults to ``"cuda"`` and must hold both models."""

    def __init__(self, model, draft, spec_tokens: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None):
        if spec_tokens is None:
            spec_tokens = _env_spec_tokens()
        if spec_tokens < 1:
            raise ValueError(
                f"spec_tokens must be >= 1, got {spec_tokens}")
        self.device = require_on(model, device)
        require_on(draft, device)
        self._model = model
        self._draft = draft
        self.spec_tokens = int(spec_tokens)
        self._dtype = dtype
        self._prefill = build_spec_prefill(model, draft)
        self._step = build_spec_step(model, draft, self.spec_tokens)
        self.proposed = 0
        self.accepted = 0
        self.rounds = 0

    def stats(self) -> dict:
        rate = (self.accepted / self.proposed) if self.proposed else 0.0
        return {"spec_tokens": self.spec_tokens, "rounds": self.rounds,
                "proposed": self.proposed, "accepted": self.accepted,
                "acceptance_rate": round(rate, 4)}

    def generate(self, prompt, decode_length: int,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """``prompt`` (N, T0) -> (N, T0 + decode_length) int32, the tokens
        of ``nn.greedy_generate``. With ``eos_id``, a row stops after
        emitting it and the rest of its row is 0."""
        k = self.spec_tokens
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None, :]
        n, t0 = prompt.shape
        if decode_length < 1:
            raise ValueError(
                f"decode_length must be >= 1, got {decode_length}")
        # a round may start at depth t0 + decode_length - 1 and writes k+1
        # positions; the cached step clamps an overflow onto earlier rows,
        # so the headroom is a correctness requirement
        total = t0 + decode_length + k
        dev = self.device
        with torch.no_grad(), evaluating(self._model), \
                evaluating(self._draft):
            st = install_decode_cache(self._model, n, total, self._dtype)
            st_d = install_decode_cache(self._draft, n, total, self._dtype)
            logp = self._prefill(st, st_d, torch.from_numpy(
                prompt.astype(np.int64)).to(dev))
            if not bool(torch.isfinite(logp).all()):
                raise FloatingPointError(
                    "non-finite logits in speculative prefill")
            cur = logp[:, t0 - 1].argmax(-1).cpu().numpy()     # (N,)
            out = [[int(cur[r])] for r in range(n)]
            done = [(eos_id is not None and int(cur[r]) == eos_id)
                    or decode_length == 1 for r in range(n)]
            while not all(done):
                props, greedy, n_acc, ok = (
                    x.cpu().numpy() for x in self._step(
                        st, st_d, torch.from_numpy(cur).to(dev)))
                self.rounds += 1
                for r in range(n):
                    if done[r]:
                        continue
                    if not ok[r]:
                        raise FloatingPointError(
                            f"non-finite logits in speculative round, "
                            f"row {r}")
                    j = int(n_acc[r])
                    self.proposed += k
                    self.accepted += j
                    for t in [int(props[r, i]) for i in range(j)] + [
                            int(greedy[r, j])]:
                        out[r].append(t)
                        if (eos_id is not None and t == eos_id) \
                                or len(out[r]) >= decode_length:
                            done[r] = True
                            break
                    if not done[r]:
                        cur[r] = out[r][-1]
        seqs = np.zeros((n, t0 + decode_length), np.int32)
        seqs[:, :t0] = prompt
        for r in range(n):
            gen = out[r][:decode_length]
            seqs[r, t0:t0 + len(gen)] = gen
        return seqs
