"""paddle_tpu_torch.nn's recurrent layers against the JAX package's: the same
weights (the JAX layers built under ``numpy_init``, carried over with
``models.layer_state_from_jax``), the same numpy inputs; outputs, final
states and the gradients of sum(out * w) + sum(state * v) with respect to
the inputs, the initial states and every parameter.

Shapes: input 6, hidden 8, batch 3, 7 steps; sequence lengths (7, 3, 5).
Tolerances: f32 outputs and states within 1e-5 x max(1, max|ref|);
gradients within 1e-4 x max|ref| (sums over time in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.models import layer_state_from_jax
from torch_api_util import on_cpu  # noqa: F401
from torch_numpy_init import numpy_init

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("on_cpu")
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
I, H, B, T = 6, 8, 3, 7
LENGTHS = np.array([7, 3, 5], np.int64)


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().cpu().numpy()


def _x(seed, *shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _carry(j, p):
    return layer_state_from_jax(p, {k: _np(v) for k, v in j.state_dict().items()})


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in _flat(e)]
    return [x]


def _inputs(*arrays):
    j = []
    for a in arrays:
        t = jp.to_tensor(a)
        t.stop_gradient = False
        j.append(t)
    return j, [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def _close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=what)


def _grad_close(got, want, what):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=what)


def _compare(j, p, jcall, pcall, jleaves, pleaves):
    """Outputs and states leaf by leaf, then the gradients of
    sum(leaf * w_leaf) over every output leaf with respect to the float
    inputs ``*leaves`` and every parameter."""
    jout, pout = _flat(jcall()), _flat(pcall())
    assert len(jout) == len(pout)
    for i, (g, w) in enumerate(zip(pout, jout)):
        _close(g, w, OUT_TOL, f"out[{i}]")
    ws = [_x(50 + i, *g.shape) for i, g in enumerate(pout)]
    jl = sum(jp.sum(jp.multiply(o, jp.to_tensor(w))) for o, w in zip(jout, ws))
    pl = sum((o * torch.from_numpy(w)).sum() for o, w in zip(pout, ws))
    jnamed = list(j.named_parameters())
    pnamed = dict(p.named_parameters())
    assert set(pnamed) == {n for n, _ in jnamed}
    jg = jp.grad(jl, list(jleaves) + [q for _, q in jnamed])
    pg = torch.autograd.grad(pl, list(pleaves) + [pnamed[n] for n, _ in jnamed])
    names = [f"input{i}" for i in range(len(jleaves))] + [n for n, _ in jnamed]
    for name, g, want in zip(names, pg, jg):
        _grad_close(g, want, name)


# ---- cells ----

CELLS = {"simple_tanh": (lambda m: m.SimpleRNNCell(I, H), 1),
         "simple_relu": (lambda m: m.SimpleRNNCell(I, H, activation="relu"), 1),
         "lstm": (lambda m: m.LSTMCell(I, H), 2),
         "gru": (lambda m: m.GRUCell(I, H), 1)}


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_step_matches_jax(kind):
    make, n_states = CELLS[kind]
    with numpy_init(1):
        j = make(jnn)
    p = _carry(j, make(pnn))
    arrays = [_x(2, B, I)] + [_x(3 + k, B, H) for k in range(n_states)]
    jl, pl = _inputs(*arrays)
    js = tuple(jl[1:]) if n_states == 2 else jl[1]
    ps = tuple(pl[1:]) if n_states == 2 else pl[1]
    _compare(j, p, lambda: j(jl[0], js), lambda: p(pl[0], ps), jl, pl)


def test_cell_default_states_and_shapes():
    with numpy_init(1):
        j = jnn.LSTMCell(I, H)
    p = _carry(j, pnn.LSTMCell(I, H))
    x = _x(2, B, I)
    jo, (jh, jc) = j(jp.to_tensor(x))
    po, (ph, pc) = p(torch.from_numpy(x))
    for g, w, what in ((po, jo, "out"), (ph, jh, "h"), (pc, jc, "c")):
        _close(g, w, OUT_TOL, what)
    assert p.state_shape == ((H,), (H,))
    st = p.get_initial_states(torch.zeros(4, I), init_value=0.5)
    assert [tuple(s.shape) for s in st] == [(4, H), (4, H)] and float(st[0][0, 0]) == 0.5


# ---- RNN over time ----

@pytest.mark.parametrize("cell", ["lstm", "gru", "simple_tanh"])
@pytest.mark.parametrize("is_reverse,time_major,with_len",
                         [(False, False, False), (True, False, False), (False, True, False),
                          (False, False, True), (True, True, True)])
def test_rnn_matches_jax(cell, is_reverse, time_major, with_len):
    make, n_states = CELLS[cell]
    with numpy_init(4):
        j = jnn.RNN(make(jnn), is_reverse=is_reverse, time_major=time_major)
    p = _carry(j, pnn.RNN(make(pnn), is_reverse=is_reverse, time_major=time_major))
    x = _x(5, T, B, I) if time_major else _x(5, B, T, I)
    jl, pl = _inputs(x, *[_x(6 + k, B, H) for k in range(n_states)])
    js = tuple(jl[1:]) if n_states == 2 else jl[1]
    ps = tuple(pl[1:]) if n_states == 2 else pl[1]
    jlen = jp.to_tensor(LENGTHS) if with_len else None
    plen = torch.from_numpy(LENGTHS) if with_len else None
    _compare(j, p, lambda: j(jl[0], js, jlen), lambda: p(pl[0], ps, plen), jl, pl)


class _JaxCell(jnn.RNNCellBase):
    """A user-defined cell: h' = tanh(x A + h B) * scale, two states."""

    def __init__(self):
        super().__init__()
        self.a = self.create_parameter((I, H))
        self.b = self.create_parameter((H, H))

    @property
    def state_shape(self):
        return ((H,), (H,))

    def forward(self, x, states, scale=1.0):
        h, s = states
        nh = jp.tanh(jp.matmul(x, self.a) + jp.matmul(h, self.b)) * scale
        return nh, (nh, s + nh)


class _PortCell(pnn.RNNCellBase):
    def __init__(self):
        super().__init__()
        self.a = self.create_parameter((I, H))
        self.b = self.create_parameter((H, H))

    @property
    def state_shape(self):
        return ((H,), (H,))

    def forward(self, x, states, scale=1.0):
        h, s = states
        nh = torch.tanh(x @ self.a + h @ self.b) * scale
        return nh, (nh, s + nh)


@pytest.mark.parametrize("is_reverse,with_len,kwargs",
                         [(False, False, {}), (True, True, {}), (False, True, {"scale": 0.5})])
def test_user_cell_eager_loop_matches_jax(is_reverse, with_len, kwargs):
    with numpy_init(7):
        j = jnn.RNN(_JaxCell(), is_reverse=is_reverse)
    p = _carry(j, pnn.RNN(_PortCell(), is_reverse=is_reverse))
    jl, pl = _inputs(_x(8, B, T, I))
    jlen = jp.to_tensor(LENGTHS) if with_len else None
    plen = torch.from_numpy(LENGTHS) if with_len else None
    _compare(j, p, lambda: j(jl[0], None, jlen, **kwargs),
             lambda: p(pl[0], None, plen, **kwargs), jl, pl)


def test_built_in_cell_with_kwargs_takes_the_eager_loop(monkeypatch):
    from paddle_tpu_torch.nn.layers import rnn

    calls = []
    monkeypatch.setattr(rnn.RNN, "_eager_loop", lambda self, *a, **k: calls.append(k))
    r = pnn.RNN(pnn.GRUCell(I, H))
    r(torch.zeros(B, T, I), extra=1)
    assert calls == [{"extra": 1}]


@pytest.mark.parametrize("with_len", [False, True])
def test_birnn_matches_jax(with_len):
    with numpy_init(9):
        j = jnn.BiRNN(jnn.LSTMCell(I, H), jnn.GRUCell(I, H))
    p = _carry(j, pnn.BiRNN(pnn.LSTMCell(I, H), pnn.GRUCell(I, H)))
    assert sorted(p.state_dict()) == sorted(j.state_dict())
    jl, pl = _inputs(_x(10, B, T, I), _x(11, B, H), _x(12, B, H), _x(13, B, H))
    jlen = jp.to_tensor(LENGTHS) if with_len else None
    plen = torch.from_numpy(LENGTHS) if with_len else None
    _compare(j, p, lambda: j(jl[0], ((jl[1], jl[2]), jl[3]), jlen),
             lambda: p(pl[0], ((pl[1], pl[2]), pl[3]), plen), jl, pl)


# ---- stacks ----

STACKS = {"simple_tanh": lambda m, **kw: m.SimpleRNN(I, H, num_layers=2, **kw),
          "simple_relu": lambda m, **kw: m.SimpleRNN(I, H, num_layers=2, activation="relu",
                                                     **kw),
          "lstm": lambda m, **kw: m.LSTM(I, H, num_layers=2, **kw),
          "gru": lambda m, **kw: m.GRU(I, H, num_layers=2, **kw)}


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_stack_with_initial_states_matches_jax(kind, direction):
    with numpy_init(11):
        j = STACKS[kind](jnn, direction=direction)
    p = _carry(j, STACKS[kind](pnn, direction=direction))
    rows = 2 * (2 if direction == "bidirect" else 1)
    n_states = 2 if kind == "lstm" else 1
    jl, pl = _inputs(_x(12, B, T, I), *[_x(13 + k, rows, B, H) for k in range(n_states)])
    js = tuple(jl[1:]) if n_states == 2 else jl[1]
    ps = tuple(pl[1:]) if n_states == 2 else pl[1]
    jlen, plen = jp.to_tensor(LENGTHS), torch.from_numpy(LENGTHS)
    _compare(j, p, lambda: j(jl[0], js, jlen), lambda: p(pl[0], ps, plen), jl, pl)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_stack_time_major_default_states_matches_jax(kind):
    with numpy_init(14):
        j = STACKS[kind](jnn, direction="bidirect", time_major=True)
    p = _carry(j, STACKS[kind](pnn, direction="bidirect", time_major=True))
    jl, pl = _inputs(_x(15, T, B, I))
    _compare(j, p, lambda: j(jl[0]), lambda: p(pl[0]), jl, pl)


def test_stack_dropout_between_layers_by_its_statistics():
    """Dropout draws from the port's generator (the masks differ from the
    JAX package's by design): eval, and p = 0, equal the no-dropout stack;
    in training the layer-0 output reaching layer 1 has ~p of its entries
    zeroed and the rest scaled by 1 / (1 - p)."""
    torch.manual_seed(0)
    a = pnn.GRU(I, 64, num_layers=2, dropout=0.4)
    b = pnn.GRU(I, 64, num_layers=2, dropout=0.0)
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(_x(16, 32, T, I))
    a.eval()
    assert torch.equal(a(x)[0], b(x)[0])
    a.train()
    a.generator = torch.Generator().manual_seed(3)
    seen = []
    layer1 = a._all_layers[1]
    handle = layer1.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    out1 = a(x)[0]
    handle.remove()
    ref = b._all_layers[0](x)[0]
    kept = seen[0] != 0
    assert abs(1 - kept.float().mean().item() - 0.4) < 0.02
    torch.testing.assert_close(seen[0][kept], ref[kept] / 0.6)
    a.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a(x)[0], out1)      # the same draws after the same seed


# ---- AMP ----

def test_o1_runs_the_recurrence_in_its_inputs_dtype():
    """rnn_scan and rnn_cell_step are on neither AMP list: f32 in, f32 out
    under O1, as in the JAX package."""
    with numpy_init(17):
        j = jnn.GRU(4, 8)
    p = _carry(j, pnn.GRU(4, 8))
    x = _x(18, 2, 5, 4)
    with jamp.auto_cast():
        jo, jh = j(jp.to_tensor(x))
    with auto_cast():
        po, ph = p(torch.from_numpy(x))
        pc = pnn.LSTMCell(4, 8)(torch.from_numpy(x[:, 0]))
    assert str(jo.dtype).endswith("float32") and str(jh.dtype).endswith("float32")
    assert po.dtype == ph.dtype == torch.float32
    assert pc[0].dtype == pc[1][1].dtype == torch.float32
    _close(po, jo, OUT_TOL, "O1 out")


def test_o2_casts_the_recurrence_to_the_low_dtype():
    with numpy_init(19):
        j = jnn.LSTM(4, 8)
    p = _carry(j, pnn.LSTM(4, 8))
    x = _x(20, 2, 5, 4)
    with jamp.auto_cast(level="O2"):
        jo, (jh, jc) = j(jp.to_tensor(x))
    with auto_cast(level="O2"):
        po, (ph, pc) = p(torch.from_numpy(x))
    for g, w in ((po, jo), (ph, jh), (pc, jc)):
        assert g.dtype == torch.bfloat16 and "bfloat16" in str(w.dtype)
    np.testing.assert_allclose(po.float().detach().numpy(),
                               np.asarray(jo._data).astype(np.float32), atol=2e-2)


# ---- state ----

def test_bidirect_lstm_state_names_and_round_trip():
    """The 16 names of the JAX 2-layer bidirect LSTM, each weight once;
    JAX -> port -> JAX bit-equal, untransposed."""
    with numpy_init(21):
        j = jnn.LSTM(4, 8, num_layers=2, direction="bidirect")
    want = {k: _np(v) for k, v in j.state_dict().items()}
    assert sorted(want) == sorted(
        f"_all_layers.{layer}.cell_{d}.{w}" for layer in (0, 1) for d in ("fw", "bw")
        for w in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    p = layer_state_from_jax(pnn.LSTM(4, 8, num_layers=2, direction="bidirect"), want)
    got = {k: v.numpy() for k, v in p.state_dict().items()}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["_all_layers.1.cell_fw.weight_ih"].shape == (32, 16)
    assert len(list(p.parameters())) == 16
    assert not any(getattr(q, "_jax_transposed", False) for q in p.parameters())


def test_param_attrs_and_no_bias():
    init = tp.nn.initializer.Constant(0.25)
    c = pnn.GRUCell(I, H, weight_ih_attr=tp.ParamAttr(initializer=init), bias_ih_attr=False,
                    bias_hh_attr=False)
    assert bool((c.weight_ih == 0.25).all()) and c.bias_ih is None
    bound = 1 / np.sqrt(H)
    assert float(c.weight_hh.detach().abs().max()) <= bound
    out, h = c(torch.ones(B, I))
    assert out.shape == (B, H) and torch.equal(out, h)


def test_elastic_checkpoint_of_an_lstm(tmp_path):
    """An LSTM tagger trained 2 steps, saved, restored into another init and
    trained on: the same losses and weights bit for bit; the checkpoint
    stores each RNN weight once, in its [gates*H, in] layout."""
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.distributed.elastic import (CheckpointManager, list_checkpoints,
                                                      restore_latest, verify_checkpoint)
    from paddle_tpu_torch.optimizer import Adam

    class Tagger(pnn.Layer):
        def __init__(self):
            super().__init__()
            self.rnn = pnn.LSTM(I, H, num_layers=2, direction="bidirect")
            self.out = pnn.Linear(2 * H, 3)

        def forward(self, x, y):
            logits = self.out(self.rnn(x)[0])
            return torch.nn.functional.cross_entropy(logits.reshape(-1, 3), y.reshape(-1))

    def make(seed):
        torch.manual_seed(seed)
        m = Tagger()
        return TrainStepEngine(m, Adam(1e-2, parameters=m.named_parameters()))

    x = torch.from_numpy(_x(22, B, T, I))
    y = torch.from_numpy(np.random.RandomState(23).randint(0, 3, (B, T)))
    eng = make(0)
    for _ in range(2):
        eng.step(x, y)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(eng, block=True)
    mgr.close()
    after = [eng.step(x, y).item() for _ in range(2)]
    eng2 = make(1)
    assert restore_latest(eng2, str(tmp_path)) == 2
    assert [eng2.step(x, y).item() for _ in range(2)] == after
    for n, q in eng.model.named_parameters():
        assert torch.equal(q, dict(eng2.model.named_parameters())[n]), n
    ((_, path),) = list_checkpoints(str(tmp_path))
    manifest = verify_checkpoint(path)
    rnn = sorted(k for k in manifest["params"] if k.startswith("rnn."))
    assert len(rnn) == 16 and not any(".rnn_fw." in k for k in rnn)
    assert manifest["params"]["rnn._all_layers.0.cell_fw.weight_ih"]["shape"] == [4 * H, I]
