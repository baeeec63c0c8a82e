"""Viterbi decoding — the port of ``paddle_tpu/text/viterbi_decode.py``
(``viterbi_decode`` and ``ViterbiDecoder``, the CRF decode of sequence
labelling).

A loop over the T steps carries the score lattice and records each
step's argmax backpointers; a second loop backtracks them in reverse.
Variable lengths are masked as the reference masks them: the lattice
freezes once ``t >= length``, and the path is 0 past each length. With
``include_bos_eos_tag`` tag ``n - 2`` is BOS and ``n - 1`` is EOS. Ties
break to the first index (``torch.argmax``'s documented rule, and
``jnp.argmax``'s).
"""
from __future__ import annotations

import torch

from ..core.tensor import as_port
from ..nn.layer import Layer

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def _as_tensor(x, device=None):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, device=device)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag=True, name=None):
    """``(scores [batch], paths [batch, seq])``: the best tag sequence of
    each row under the emission ``potentials`` ``[batch, seq, tags]`` and
    ``transition_params`` ``[tags, tags]`` (from, to), over the first
    ``lengths[b]`` steps. Paths are int32, as the reference's."""
    pot = _as_tensor(potentials)
    trans = _as_tensor(transition_params, pot.device)
    lengths = _as_tensor(lengths, pot.device).detach().to(torch.int64)
    b, t, n = pot.shape
    if include_bos_eos_tag:
        bos, eos = n - 2, n - 1
        alpha = pot[:, 0] + trans[bos][None, :]
    else:
        alpha = pot[:, 0]
    ptrs = []
    for step in range(1, t):
        cand = alpha[:, :, None] + trans[None, :, :]    # [b, from, to]
        ptr = torch.argmax(cand, dim=1)
        best = torch.gather(cand, 1, ptr[:, None, :])[:, 0] + pot[:, step]
        ptrs.append(ptr)
        active = (step < lengths)[:, None]             # length counts step 0
        alpha = torch.where(active, best, alpha)
    final = alpha + trans[:, eos][None, :] if include_bos_eos_tag \
        else alpha
    last_tag = torch.argmax(final, dim=-1)
    scores = torch.gather(final, 1, last_tag[:, None])[:, 0]
    path = [last_tag]
    tag = last_tag
    for step in range(t - 1, 0, -1):
        # follow the pointer only inside the sequence; past its end the
        # final tag stays (those positions are zeroed below)
        prev = torch.gather(ptrs[step - 1], 1, tag[:, None])[:, 0]
        tag = torch.where(step <= lengths - 1, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    valid = torch.arange(t, device=pot.device)[None, :] < lengths[:, None]
    path = torch.where(valid, path, torch.zeros_like(path))
    return as_port(scores), as_port(path.to(torch.int32))


class ViterbiDecoder(Layer):
    """``viterbi_decode`` over fixed ``transitions`` (reference
    ``text/viterbi_decode.py:91``)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = _as_tensor(transitions)
        self._include = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self._include)
