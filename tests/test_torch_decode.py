"""paddle_tpu_torch.nn's beam search (``BeamSearchDecoder`` + ``dynamic_decode``)
against the JAX package's: the greedy chain of tests/test_decode.py's table
cell, and an LSTMCell with an embedding and an output projection whose
weights are carried over from the JAX layers (``layer_state_from_jax``).

Predicted ids equal, but where the two packages' ``topk`` could order a
near-tie differently: at the first step where the ids part, the scores of
the beams involved are within 2e-3 (the serving phases' near-tie). Scores
and lengths within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_state_from_jax
from torch_api_util import on_cpu  # noqa: F401
from torch_numpy_init import numpy_init

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("on_cpu")
TOL = 1e-5
NEAR_TIE = 2e-3


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().cpu().numpy()


def _carry(j, p):
    return layer_state_from_jax(p, {k: _np(v) for k, v in j.state_dict().items()})


def assert_ids_equal_or_near_tie(got_ids, want_ids, want_scores):
    """[N, T, beam] ids equal; where a batch row parts, the JAX scores of
    the parting beams at that step are within NEAR_TIE of each other."""
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    assert got_ids.shape == want_ids.shape
    for n in range(got_ids.shape[0]):
        diff = np.argwhere(got_ids[n] != want_ids[n])
        if len(diff):
            t = diff[0][0]
            beams = sorted({int(b) for tt, b in diff if tt == t})
            s = want_scores[n, t]
            span = [abs(s[b] - s[c]) for b in beams for c in range(len(s)) if c != b]
            assert min(span) <= NEAR_TIE, (n, t, beams, s)


class _JaxTableCell(jnn.RNNCellBase):
    """tests/test_decode.py's deterministic 'LM': logits from a table row."""

    def __init__(self, table):
        super().__init__()
        self.table = jp.to_tensor(table)

    @property
    def state_shape(self):
        return (4,)

    def forward(self, inputs, states=None, **kwargs):
        return self.table[inputs.astype("int64")], states


class _PortTableCell(pnn.RNNCellBase):
    def __init__(self, table):
        super().__init__()
        self.table = torch.from_numpy(table)

    @property
    def state_shape(self):
        return (4,)

    def forward(self, inputs, states=None, **kwargs):
        return self.table[inputs.long()], states


def test_greedy_chain_matches_jax():
    vocab = 5
    table = np.full((vocab, vocab), -10.0, np.float32)
    for t in range(vocab):
        table[t, (t + 1) % vocab] = 10.0
    jdec = jnn.BeamSearchDecoder(_JaxTableCell(table), start_token=0, end_token=4, beam_size=2)
    pdec = pnn.BeamSearchDecoder(_PortTableCell(table), start_token=0, end_token=4,
                                 beam_size=2)
    init = np.zeros((2, 4), np.float32)
    jout, jst = jnn.dynamic_decode(jdec, inits=jp.to_tensor(init), max_step_num=8)
    pout, pst = pnn.dynamic_decode(pdec, inits=torch.from_numpy(init), max_step_num=8)
    np.testing.assert_array_equal(_np(pout), _np(jout))
    np.testing.assert_array_equal(_np(pout)[0, :4, 0], [1, 2, 3, 4])
    assert (_np(pout)[0, 4:, 0] == 4).all()
    np.testing.assert_array_equal(_np(pst.lengths), _np(jst.lengths))
    assert int(_np(pst.lengths)[0, 0]) == 4
    np.testing.assert_allclose(_np(pst.log_probs), _np(jst.log_probs), rtol=0, atol=TOL)
    np.testing.assert_array_equal(_np(pst.finished), _np(jst.finished))


def _lstm_decoders(vocab, hidden, beam, seed):
    with numpy_init(seed):
        jemb, jcell, jproj = (jnn.Embedding(vocab, hidden), jnn.LSTMCell(hidden, hidden),
                              jnn.Linear(hidden, vocab))
    pemb = _carry(jemb, pnn.Embedding(vocab, hidden))
    pcell = _carry(jcell, pnn.LSTMCell(hidden, hidden))
    pproj = _carry(jproj, pnn.Linear(hidden, vocab))
    kw = dict(start_token=0, end_token=1, beam_size=beam)
    return (jnn.BeamSearchDecoder(jcell, embedding_fn=jemb, output_fn=jproj, **kw),
            pnn.BeamSearchDecoder(pcell, embedding_fn=pemb, output_fn=pproj, **kw))


@pytest.mark.parametrize("vocab,hidden,beam,batch,steps,seed",
                         [(7, 8, 3, 2, 5, 0), (40, 16, 4, 3, 12, 1), (12, 16, 5, 4, 20, 2)])
def test_lstm_with_embedding_matches_jax(vocab, hidden, beam, batch, steps, seed):
    """tests/test_decode.py:61's decoder, held against the JAX one; the
    scores of every step come from output_time_major's (scores, ids,
    parents) triple."""
    jdec, pdec = _lstm_decoders(vocab, hidden, beam, seed)
    rng = np.random.RandomState(seed)
    h0, c0 = (rng.standard_normal((batch, hidden)).astype(np.float32) for _ in range(2))
    jout, jst, jlen = jnn.dynamic_decode(jdec, inits=(jp.to_tensor(h0), jp.to_tensor(c0)),
                                         max_step_num=steps, return_length=True)
    pout, pst, plen = pnn.dynamic_decode(pdec, inits=(torch.from_numpy(h0),
                                                      torch.from_numpy(c0)),
                                         max_step_num=steps, return_length=True)
    assert tuple(pout.shape) == tuple(jout.shape) and pout.dtype == torch.int64
    # every step's scores (time-major; the JAX run's, for the near-tie rule)
    jsteps = _step_scores(jdec, jp, (jp.to_tensor(h0), jp.to_tensor(c0)), steps)
    assert_ids_equal_or_near_tie(_np(pout), _np(jout), jsteps)
    if np.array_equal(_np(pout), _np(jout)):
        np.testing.assert_allclose(_np(pst.log_probs), _np(jst.log_probs), rtol=0, atol=TOL)
        np.testing.assert_array_equal(_np(plen), _np(jlen))
        np.testing.assert_array_equal(_np(pst.finished), _np(jst.finished))
        for a, b in zip(pst.cell_states, jst.cell_states):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=TOL)
    psteps = _step_scores(pdec, None, (torch.from_numpy(h0), torch.from_numpy(c0)), steps)
    t = min(psteps.shape[1], jsteps.shape[1])
    np.testing.assert_allclose(psteps[:, :t], jsteps[:, :t], rtol=0,
                               atol=TOL * max(1.0, float(np.abs(jsteps).max())))


def _step_scores(dec, jax_pkg, inits, steps):
    """[N, T, beam] scores of each step (dynamic_decode, time-major, the
    decoder's raw OutputWrapper before finalize)."""
    captured = {}
    real = dec.finalize

    def keep(outputs, final_states, lengths):
        captured["scores"] = outputs.scores
        return real(outputs, final_states, lengths)

    dec.finalize = keep
    try:
        mod = jnn if jax_pkg is not None else pnn
        mod.dynamic_decode(dec, inits=inits, max_step_num=steps, output_time_major=True)
    finally:
        del dec.finalize
    return np.swapaxes(_np(captured["scores"]), 0, 1)


def test_output_time_major_and_the_finished_stop():
    """Decoding stops at the step where every beam has finished (read on
    the host), before max_step_num; time-major output is [T, N, beam]."""
    vocab = 4
    table = np.full((vocab, vocab), -10.0, np.float32)
    table[:, 1] = 10.0                  # every beam ends at once
    dec = pnn.BeamSearchDecoder(_PortTableCell(table), start_token=0, end_token=1,
                                beam_size=2)
    out, st = pnn.dynamic_decode(dec, inits=torch.zeros(3, 4), max_step_num=50,
                                 output_time_major=True)
    jdec = jnn.BeamSearchDecoder(_JaxTableCell(table), start_token=0, end_token=1,
                                 beam_size=2)
    jout, jst = jnn.dynamic_decode(jdec, inits=jp.to_tensor(np.zeros((3, 4), np.float32)),
                                   max_step_num=50, output_time_major=True)
    np.testing.assert_array_equal(_np(out), _np(jout))
    assert tuple(out.shape) == (2, 3, 2)       # step 1 ends beam 0, step 2 beam 1
    assert bool(st.finished.all())


def test_zero_steps_raises():
    dec = pnn.BeamSearchDecoder(_PortTableCell(np.zeros((3, 3), np.float32)), 0, 1, 2)
    with pytest.raises(ValueError, match="zero steps"):
        pnn.dynamic_decode(dec, inits=torch.zeros(1, 4), max_step_num=0)
