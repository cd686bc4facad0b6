"""Beam-search sequence decoding: ``SequenceBeamSearch`` and ``greedy_decode``.

Counterpart of ``bigdl_tpu/nn/beam_search.py``: beam search over a causal
LM decoder with the GNMT length penalty ``((5 + len) / 6) ** alpha``, an
EOS-terminated pool of finished beams, and a fixed decode length. As in
JAX it is the static padded block: every step runs the decoder's full
forward over the same (N·beam, T0 + decode_length) token block (so the
flash forward runs at that shape), and reads the log-probs at the step's
position. The KV-cached form is ``nn.incremental.beam_generate``; both
take their step from :func:`beam_step`, so they select alike.

Ties are broken as ``lax.top_k`` breaks them, the lower index first (a
stable descending sort).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container, evaluating
from bigdl_tpu_torch.utils.device import require_on
from bigdl_tpu_torch.utils.table import T

_NEG = -1.0e9


def _length_penalty(length: float, alpha: float) -> float:
    return ((5.0 + length) / 6.0) ** alpha


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties lower index
    first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)`` for (n, B[, L])."""
    if x.dim() == 3:
        return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return x.gather(1, idx)


def new_beams(prompt: torch.Tensor, beam_size: int, total: int,
              pad_id: int) -> tuple:
    """The search state at the start: every beam carries the prompt, only
    beam 0 is live, the finished pool is empty. ``(seqs, alive_lp,
    fin_seqs, fin_scores, fin_flags)``."""
    n, t0 = prompt.shape
    dev = prompt.device
    seqs = torch.full((n, beam_size, total), pad_id, dtype=torch.long,
                      device=dev)
    seqs[:, :, :t0] = prompt[:, None, :]
    alive = torch.full((n, beam_size), _NEG, device=dev)
    alive[:, 0] = 0.0
    fin_seqs = torch.full_like(seqs, pad_id)
    fin_scores = torch.full((n, beam_size), _NEG, device=dev)
    fin_flags = torch.zeros((n, beam_size), dtype=torch.bool, device=dev)
    return seqs, alive, fin_seqs, fin_scores, fin_flags


def beam_step(beams: tuple, step_lp: torch.Tensor, col: int,
              dec_len: float, eos_id: int, alpha: float) -> tuple:
    """One expansion: ``step_lp`` (n, B, V) are the live beams' next-token
    log-probs, the new token goes to column ``col``, and a beam ending in
    EOS now is scored at ``dec_len`` tokens. Returns the new state and,
    per new live beam, its parent beam and its token (each (n, B))."""
    seqs, alive_lp, fin_seqs, fin_scores, fin_flags = beams
    n, b, v = step_lp.shape
    cand = (alive_lp[:, :, None] + step_lp).reshape(n, b * v)
    vals, idx = _top_k(cand, 2 * b)
    beam_idx, tok = idx // v, idx % v
    cand_seqs = _take(seqs, beam_idx)                         # (n, 2B, L)
    cand_seqs[:, :, col] = tok
    is_eos = tok == eos_id
    # alive: the best B candidates that did not end
    alive_vals, alive_sel = _top_k(torch.where(is_eos, _NEG, vals), b)
    # finished: the candidates that ended, with the length penalty, merged
    # into the pool
    cand_fin = torch.where(is_eos, vals / _length_penalty(dec_len, alpha),
                           _NEG)
    top_scores, sel = _top_k(torch.cat([fin_scores, cand_fin], 1), b)
    new = (_take(cand_seqs, alive_sel), alive_vals,
           _take(torch.cat([fin_seqs, cand_seqs], 1), sel), top_scores,
           _take(torch.cat([fin_flags, is_eos], 1), sel))
    return new, _take(beam_idx, alive_sel), _take(tok, alive_sel)


def final_ranking(beams: tuple, decode_length: int, alpha: float) -> tuple:
    """Finished beams compete with the live ones (scored at the full decode
    length); the best B, best first: ``(sequences int32, scores)``."""
    seqs, alive_lp, fin_seqs, fin_scores, fin_flags = beams
    b = alive_lp.shape[1]
    alive_scores = alive_lp / _length_penalty(float(decode_length), alpha)
    scores, sel = _top_k(torch.cat(
        [torch.where(fin_flags, fin_scores, _NEG), alive_scores], 1), b)
    return _take(torch.cat([fin_seqs, seqs], 1), sel).to(torch.int32), scores


class SequenceBeamSearch(Container):
    """Beam-search decode around a causal LM ``decoder`` (child ``"0"``).

    ``forward(prompt)`` with ``prompt`` (N, T0) ids returns a Table of
    ``(sequences, scores)``: sequences (N, beam, T0 + decode_length) int32,
    best beam first, positions after EOS filled with ``pad_id``; scores
    (N, beam) = total log-prob / length_penalty(decoded_len, alpha).
    The decoder runs in eval mode. ``beam_size=1, alpha=0`` is greedy
    decoding."""

    def __init__(self, decoder: AbstractModule, beam_size: int, eos_id: int,
                 decode_length: int, alpha: float = 0.0, pad_id: int = 0):
        super().__init__(decoder)
        if beam_size < 1 or decode_length < 1:
            raise ValueError("beam_size and decode_length must be >= 1")
        self.beam_size = int(beam_size)
        self.eos_id = int(eos_id)
        self.decode_length = int(decode_length)
        self.alpha = float(alpha)
        self.pad_id = int(pad_id)

    def run(self, input, state=None):
        decoder = self[0]
        dev = next(decoder.parameters()).device
        prompt = torch.as_tensor(input, dtype=torch.long).to(dev)
        if prompt.dim() != 2:
            raise ValueError(f"prompt must be (N, T0) ids, got "
                             f"{tuple(prompt.shape)}")
        n, t0 = prompt.shape
        b, total = self.beam_size, t0 + self.decode_length
        beams = new_beams(prompt, b, total, self.pad_id)
        with torch.no_grad(), evaluating(decoder):
            for i in range(self.decode_length):
                out = decoder(beams[0].reshape(n * b, total))
                step_lp = torch.log_softmax(out[:, t0 + i - 1].float(), -1)
                beams, _, _ = beam_step(beams, step_lp.reshape(n, b, -1),
                                        t0 + i, i + 1.0, self.eos_id,
                                        self.alpha)
        return T(*final_ranking(beams, self.decode_length, self.alpha)), \
            state


def greedy_decode(decoder: AbstractModule, prompt, decode_length: int,
                  eos_id=None, pad_id: int = 0, device=None):
    """Greedy (beam 1, alpha 0) decode over a built module: ``(sequences
    (N, T0 + decode_length) int32, scores (N,))``. ``device`` defaults to
    ``"cuda"`` and must hold the decoder."""
    require_on(decoder, device)
    bs = SequenceBeamSearch(decoder, 1, -1 if eos_id is None else eos_id,
                            decode_length, 0.0, pad_id)
    out = bs.forward(prompt)
    return out[1][:, 0], out[2][:, 0]
