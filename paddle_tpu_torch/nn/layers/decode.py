"""Beam-search decoding (counterpart of paddle_tpu/nn/layers/decode.py): the
``Decoder`` protocol, ``BeamSearchDecoder``, ``dynamic_decode`` and
``gather_tree``.

Decoding is data-dependent: ``dynamic_decode`` runs a host loop of
``decoder.step`` calls and reads ``finished`` back to the host before every
step, as the JAX package does. A ``BeamSearchDecoder`` step runs the cell on
``[batch·beam]`` rows, adds the step's log-softmax to each beam's running
log-probability and takes ``topk`` over ``beam·vocab`` per batch row. The
dead beams start at -1e9 (not -inf, so sums stay finite); a finished beam
extends only with ``end_token`` at log-probability 0; the parent beam is
``index // vocab``, the token ``index % vocab``; the cell states,
``finished`` and ``lengths`` are gathered by parent. The top ``beam``
candidates come from a stable descending sort, so equal scores rank in
index order as XLA's ``top_k`` ranks them (``torch.topk``'s order among
ties is its own); two devices can still order a near-tie differently.
``gather_tree`` walks the parent pointers back on the host.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ...ops import activation as A


class Decoder:
    """Abstract decode protocol (reference rnn.py:Decoder)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError

    @property
    def tracks_own_finished(self):
        return False


class BeamSearchDecoder(Decoder):
    """Beam search over a cell's token distribution (reference rnn.py:850)."""

    OutputWrapper = collections.namedtuple(
        "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))
    StateWrapper = collections.namedtuple(
        "StateWrapper", ("cell_states", "log_probs", "finished", "lengths"))

    def __init__(self, cell, start_token, end_token, beam_size, embedding_fn=None,
                 output_fn=None):
        self.cell = cell
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    # ---- beam shape helpers (reference: _expand_to_beam_size/_merge/_split) ----
    def _expand_to_beam_size(self, x):
        return x.unsqueeze(1).expand(x.shape[0], self.beam_size, *x.shape[1:])

    def _merge_batch_beams(self, x):
        return x.reshape(-1, *x.shape[2:])

    def _split_batch_beams(self, x):
        return x.reshape(-1, self.beam_size, *x.shape[1:])

    def _map_states(self, states, fn):
        if isinstance(states, (tuple, list)):
            return tuple(self._map_states(s, fn) for s in states)
        return fn(states)

    def initialize(self, initial_cell_states):
        first = initial_cell_states
        while isinstance(first, (tuple, list)):
            first = first[0]
        batch, device = first.shape[0], first.device
        self.batch_size = batch
        cell_states = self._map_states(
            initial_cell_states, lambda s: self._merge_batch_beams(self._expand_to_beam_size(s)))
        # beam 0 live, the others at -1e9, so step 1 expands from beam 0 only
        log_probs = torch.full((batch, self.beam_size), -1e9, dtype=torch.float32,
                               device=device)
        log_probs[:, 0] = 0.0
        finished = torch.zeros(batch, self.beam_size, dtype=torch.bool, device=device)
        lengths = torch.zeros(batch, self.beam_size, dtype=torch.int64, device=device)
        init_ids = torch.full((batch, self.beam_size), self.start_token, dtype=torch.int64,
                              device=device)
        init_inputs = self.embedding_fn(init_ids) if self.embedding_fn else init_ids
        return (init_inputs, self.StateWrapper(cell_states, log_probs, finished, lengths),
                finished)

    def step(self, time, inputs, states, **kwargs):
        cell_out, next_cell_states = self.cell(self._merge_batch_beams(inputs),
                                               states.cell_states, **kwargs)
        if self.output_fn is not None:
            cell_out = self.output_fn(cell_out)
        vocab = cell_out.shape[-1]
        step_log_probs = A.log_softmax(self._split_batch_beams(cell_out))    # [N, B, V]
        # a finished beam extends only with end_token (log-prob 0), -1e9 elsewhere
        fin = states.finished.to(torch.float32).unsqueeze(-1)
        onehot_end = torch.full((vocab,), -1e9, dtype=torch.float32, device=cell_out.device)
        onehot_end[self.end_token] = 0.0
        step_log_probs = step_log_probs * (1.0 - fin) + fin * onehot_end
        total = states.log_probs.unsqueeze(-1) + step_log_probs               # [N, B, V]
        # the top beam_size of beam*vocab; equal scores in index order, as
        # XLA's top_k gives them (torch.topk's order among ties is its own)
        topk_scores, topk_idx = torch.sort(total.reshape(-1, self.beam_size * vocab), dim=-1,
                                           descending=True, stable=True)
        topk_scores = topk_scores[:, :self.beam_size]                        # [N, B]
        topk_idx = topk_idx[:, :self.beam_size]
        parent = torch.div(topk_idx, vocab, rounding_mode="floor")
        token = torch.remainder(topk_idx, vocab)

        # gather the beam-indexed state by parent
        rows = (parent + torch.arange(self.batch_size, device=parent.device)[:, None]
                * self.beam_size).reshape(-1)
        next_cell_states = self._map_states(next_cell_states,
                                            lambda s: s.index_select(0, rows))
        next_finished = states.finished.reshape(-1).index_select(0, rows).reshape(
            self.batch_size, self.beam_size)
        next_lengths = states.lengths.reshape(-1).index_select(0, rows).reshape(
            self.batch_size, self.beam_size)
        next_lengths = next_lengths + torch.logical_not(next_finished).to(torch.int64)
        next_finished = torch.logical_or(next_finished, token == self.end_token)

        next_state = self.StateWrapper(next_cell_states, topk_scores, next_finished,
                                       next_lengths)
        output = self.OutputWrapper(topk_scores, token, parent)
        next_inputs = self.embedding_fn(token) if self.embedding_fn else token
        return output, next_state, next_inputs, next_finished

    def finalize(self, outputs, final_states, sequence_lengths):
        return gather_tree(outputs.predicted_ids, outputs.parent_ids), final_states

    @property
    def tracks_own_finished(self):
        return True


def gather_tree(ids, parents):
    """Full beams from each step's tokens and parent pointers ([T, N, beam]
    each), walked back from the last step on the host, as the JAX op does."""
    ids_np = ids.detach().cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
    par_np = parents.detach().cpu().numpy() if torch.is_tensor(parents) \
        else np.asarray(parents)
    T, N, B = ids_np.shape
    out = np.zeros_like(ids_np)
    for n in range(N):
        for b in range(B):
            beam = b
            for t in range(T - 1, -1, -1):
                out[t, n, b] = ids_np[t, n, beam]
                beam = par_np[t, n, beam]
    res = torch.from_numpy(out)
    return res.to(ids.device) if torch.is_tensor(ids) else res


def dynamic_decode(decoder, inits=None, max_step_num=None, output_time_major=False,
                   impute_finished=False, is_test=False, return_length=False, **kwargs):
    """Run ``decoder`` until every sequence has finished or ``max_step_num``
    steps (reference rnn.py:1260); ``finished`` is read on the host before
    each step. Returns (outputs, final states[, lengths]), batch-major
    unless ``output_time_major``."""
    inputs, states, finished = decoder.initialize(inits)
    acc = []
    step = 0
    while max_step_num is None or step < max_step_num:
        if bool(finished.all()):
            break
        outputs, next_states, next_inputs, next_finished = decoder.step(
            step, inputs, states, **kwargs)
        if not decoder.tracks_own_finished:
            next_finished = torch.logical_or(next_finished, finished)
        acc.append(outputs)
        inputs, states, finished = next_inputs, next_states, next_finished
        step += 1
    if not acc:
        raise ValueError("dynamic_decode ran zero steps; check initial finished state")

    # stack along time (time-major first, like the reference)
    first = acc[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        stacked = type(first)(*[torch.stack([getattr(o, f) for o in acc], 0)
                                for f in first._fields])
    else:
        stacked = torch.stack(acc, 0)
    lengths = getattr(states, "lengths", None)
    final_outputs, final_states = decoder.finalize(stacked, states, lengths)
    if not output_time_major:
        def to_batch_major(x):
            return x.transpose(0, 1) if torch.is_tensor(x) else x

        if isinstance(final_outputs, tuple) and hasattr(final_outputs, "_fields"):
            final_outputs = type(final_outputs)(*[to_batch_major(getattr(final_outputs, f))
                                                  for f in final_outputs._fields])
        else:
            final_outputs = to_batch_major(final_outputs)
    if return_length:
        return final_outputs, final_states, lengths
    return final_outputs, final_states
