"""Sequence decoding — the port of ``paddle_tpu/nn/decode.py``:
``Decoder``, ``BeamSearchDecoder``, ``dynamic_decode`` and
``gather_tree``.

``dynamic_decode`` is a Python loop over the decoder's steps that stops
once every sequence has finished or after ``max_step_num`` steps (256 by
default). Its outputs are always ``max_step_num`` long, zero past the
last step, as the reference's preallocated buffers are. Beam selection
takes the ``beam`` best of ``beam * vocab`` scores by a stable descending
sort, so ties go to the lower index, as ``lax.top_k``'s do (``torch.topk``
makes no such promise).
"""
from __future__ import annotations

import torch

from ..core.tensor import as_port
from .rnn import _map

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode", "gather_tree"]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in tree for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def _top_k(x, k):
    """The ``k`` largest of the last dimension, largest first, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Decoder:
    """A decoder driven by :func:`dynamic_decode`: ``initialize``,
    ``step``, ``finalize`` and ``tracks_own_finished``."""

    def initialize(self, inits):
        """-> ``(initial_inputs, initial_states, initial_finished)``"""
        raise NotImplementedError

    def final_sequence_lengths(self, final_states):
        """The per-sequence lengths from the decoder's state, or None to
        keep the loop's counts."""
        return None

    def step(self, time, inputs, states, **kwargs):
        """-> ``(outputs, next_states, next_inputs, finished)``"""
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a step cell: per-beam log-probabilities add up, a
    finished beam extends only with ``end_token`` at no cost, the ``beam``
    best of ``beam * vocab`` continue, and ``finalize`` backtracks the
    parents with :func:`gather_tree`.

    ``cell(inputs [batch * beam, ...], states) -> (outputs,
    next_states)``; ``embedding_fn`` maps token ids to the cell's inputs;
    ``output_fn`` maps the cell's outputs to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """``[batch, ...]`` -> ``[batch * beam, ...]``, each row repeated."""
        return torch.repeat_interleave(x, beam_size, dim=0)

    def _inputs(self, tokens):
        tokens = as_port(tokens)
        return self.embedding_fn(tokens) if self.embedding_fn else tokens

    def initialize(self, initial_cell_states):
        first = _leaves(initial_cell_states)[0]
        batch, dev, beam = first.shape[0], first.device, self.beam_size
        tiled = _map(lambda s: torch.repeat_interleave(s, beam, dim=0),
                     initial_cell_states)
        log_probs = torch.full((batch, beam), float("-inf"),
                               dtype=torch.float32, device=dev)
        log_probs[:, 0] = 0.0  # every beam starts from the same state
        finished = torch.zeros((batch, beam), dtype=torch.bool, device=dev)
        lengths = torch.zeros((batch, beam), dtype=torch.int32, device=dev)
        tokens = torch.full((batch * beam,), self.start_token,
                            dtype=torch.int32, device=dev)
        state = {"cell": tiled, "log_probs": log_probs,
                 "finished": finished, "lengths": lengths}
        return self._inputs(tokens), state, finished

    def step(self, time, inputs, states, **kwargs):
        log_probs, finished = states["log_probs"], states["finished"]
        batch, beam = log_probs.shape
        cell_out, next_cell = self.cell(inputs, states["cell"])
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        logits = cell_out.to(torch.float32)
        vocab = logits.shape[-1]
        step_lp = torch.log_softmax(logits, dim=-1).reshape(batch, beam,
                                                            vocab)
        # built by a comparison: writing one element of a CUDA tensor from
        # a Python number copies it from the host and waits for the copy
        eos_only = torch.full(
            (vocab,), float("-inf"), dtype=torch.float32,
            device=logits.device).masked_fill(
                torch.arange(vocab, device=logits.device) == self.end_token,
                0.0)
        step_lp = torch.where(finished[..., None], eos_only, step_lp)
        total = log_probs[..., None] + step_lp
        top_lp, top_idx = _top_k(total.reshape(batch, beam * vocab), beam)
        parent = (top_idx // vocab).to(torch.int32)
        token = (top_idx % vocab).to(torch.int32)
        rows = torch.arange(batch, device=logits.device)[:, None]
        gidx = (parent.long() + rows * beam).reshape(-1)
        next_cell = _map(lambda s: s[gidx], next_cell)
        prev_finished = finished[rows, parent.long()]
        prev_lengths = states["lengths"][rows, parent.long()]
        finished = prev_finished | (token == self.end_token)
        lengths = prev_lengths + (~prev_finished).to(torch.int32)
        outputs = {"scores": top_lp, "predicted_ids": token,
                   "parent_ids": parent}
        next_state = {"cell": next_cell, "log_probs": top_lp,
                      "finished": finished, "lengths": lengths}
        return outputs, next_state, self._inputs(token.reshape(-1)), finished

    def finalize(self, outputs, final_states, sequence_lengths):
        """Whole sequences ``[T, batch, beam]`` from the parent pointers.
        Past the loop's last step (the largest length) the buffers hold
        zeros; the parents there are taken as the identity, so that each
        beam column reaches the written steps intact."""
        parents = outputs["parent_ids"]
        steps, beam = parents.shape[0], parents.shape[2]
        t_exit = torch.max(sequence_lengths)
        ident = torch.arange(beam, dtype=parents.dtype,
                             device=parents.device).expand(parents.shape)
        written = torch.arange(steps, device=parents.device)[:, None, None] \
            < t_exit
        parents = torch.where(written, parents, ident)
        return gather_tree(outputs["predicted_ids"], parents), final_states

    def final_sequence_lengths(self, final_states):
        """The parent-gathered lengths of the state (the loop's counts
        are wrong once beams are reordered)."""
        return final_states["lengths"]

    @property
    def tracks_own_finished(self):
        return True


def gather_tree(ids, parents):
    """Whole beam-search sequences from each step's tokens and parent
    pointers, ``[max_time, batch, beam]``: column ``(b, k)`` is the
    history of final beam ``k``, traced back from the last step."""
    steps, batch, beam = ids.shape
    beams = torch.arange(beam, device=ids.device).expand(batch, beam)
    rows = torch.arange(batch, device=ids.device)[:, None]
    out = [None] * steps
    for t in range(steps - 1, -1, -1):
        out[t] = ids[t][rows, beams]
        beams = parents[t][rows, beams].long()
    return as_port(torch.stack(out))


def _bcast(mask, like):
    while mask.dim() < like.dim():
        mask = mask[..., None]
    return mask.expand(like.shape)


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every sequence has finished or
    ``max_step_num`` steps (256 by default) have run. Returns
    ``(outputs, final_states)``, and the sequence lengths with
    ``return_length``. The outputs are ``[batch, max_step_num, ...]``
    (``[max_step_num, batch, ...]`` with ``output_time_major``), zero past
    the last step. ``impute_finished`` keeps a finished row's state and
    zeroes its outputs; a decoder that reorders rows
    (``tracks_own_finished``) refuses it, as in the reference."""
    max_step_num = 256 if max_step_num is None else int(max_step_num)
    if impute_finished and decoder.tracks_own_finished:
        raise ValueError(
            "impute_finished is incompatible with decoders that reorder rows "
            "each step (tracks_own_finished=True, e.g. BeamSearchDecoder): "
            "the [batch, beam] finished mask cannot be aligned with the "
            "decoder's [batch*beam, ...] internal state.")
    inputs, states, finished = decoder.initialize(inits)
    out, states, inputs, fin = decoder.step(0, inputs, states, **kwargs)
    outs = [out]
    finished = fin if decoder.tracks_own_finished else finished | fin
    lengths = finished.to(torch.int32)
    t = 1
    while t < max_step_num and not bool(finished.all()):
        out, nstates, inputs, fin = decoder.step(t, inputs, states, **kwargs)
        if impute_finished:
            nstates = _map(lambda new, old: torch.where(
                _bcast(finished, new), old, new), nstates, states)
            out = _map(lambda o: torch.where(_bcast(finished, o),
                                             torch.zeros_like(o), o), out)
        outs.append(out)
        lengths = torch.where(finished, lengths, torch.full_like(lengths,
                                                                 t + 1))
        finished = fin if decoder.tracks_own_finished else finished | fin
        states = nstates
        t += 1
    lengths = torch.where(finished, lengths,
                          torch.full_like(lengths, max_step_num))
    own = decoder.final_sequence_lengths(states)
    if own is not None:
        lengths = own

    def buffer(*steps):
        full = steps[0].new_zeros((max_step_num,) + tuple(steps[0].shape))
        full[:len(steps)] = torch.stack(steps)
        return full

    outputs, final_states = decoder.finalize(_map(buffer, *outs), states,
                                             lengths)
    if not output_time_major:
        outputs = _map(lambda o: torch.movedim(o, 0, 1), outputs)
    outputs, final_states = _map(as_port, outputs), _map(as_port,
                                                         final_states)
    if return_length:
        return outputs, final_states, as_port(lengths)
    return outputs, final_states
