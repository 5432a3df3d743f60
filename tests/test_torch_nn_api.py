"""The port's nn API against the JAX package's: the initializers,
``ParamAttr`` / ``create_parameter`` / ``Parameter`` / ``Layer``'s methods,
``nn.utils`` and the layers of this slice (paddle_tpu_torch/nn/).

Layers are built in both packages (the JAX ones under ``numpy_init``), the
JAX state carried over with ``layer_state_from_jax``, and the outputs and
the gradients of sum(out * w) (inputs and parameters) compared.
Tolerances: f32 values rtol 1e-5 atol 1e-5; gradients rtol 1e-4 atol 1e-5
(sums in another order). Random initializers are held by their moments
(5 standard errors), bounds and determinism under ``seed``: their draws
differ from JAX's threefry by design.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models import layer_state_from_jax
from torch_api_util import assert_same, on_cpu  # noqa: F401
from torch_numpy_init import numpy_init

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("on_cpu")
VAL = (1e-5, 1e-5)
GRAD = (1e-4, 1e-5)
I64 = np.int64
JI, PI = jnn.initializer, pnn.initializer


@pytest.fixture
def global_init_restored():
    yield
    JI.set_global_initializer(None, None)
    PI.set_global_initializer(None, None)


def _np(t):
    if hasattr(t, "_data"):
        return np.asarray(t._data)
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _jt(a, grad=False):
    t = jp.to_tensor(a, dtype=str(a.dtype))
    if grad:
        t.stop_gradient = False
    return t


# ---------------------------------------------------------------- initializers

@pytest.mark.parametrize("make,shape", [
    (lambda I: I.Constant(0.25), (3, 4)),
    (lambda I: I.constant(-1.5), (2,)),
    (lambda I: I.Assign(np.arange(12, dtype=np.float32).reshape(3, 4)), (3, 4)),
    (lambda I: I.Assign([[1.0, 2.0], [3.0, 4.0]]), (4,)),
    (lambda I: I.Dirac(), (4, 3, 3, 3)),
    (lambda I: I.Dirac(groups=2), (4, 2, 3)),
    (lambda I: I.Bilinear(), (2, 2, 4, 4)),
])
def test_deterministic_initializers_give_the_jax_values(make, shape):
    want = _np(make(JI)(shape, "float32"))
    got = make(PI)(shape, "float32")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,kw,shape,bound", [
    ("Normal", {"mean": 0.5, "std": 2.0}, (200, 250), None),
    ("TruncatedNormal", {"mean": 0.0, "std": 0.5}, (200, 250), 1.0),
    ("Uniform", {"low": -0.3, "high": 0.7}, (200, 250), None),
    ("XavierNormal", {}, (300, 100), None),
    ("XavierUniform", {"gain": 2.0}, (300, 100), None),
    ("XavierNormal", {"fan_in": 10, "fan_out": 30}, (200, 250), None),
    ("KaimingNormal", {}, (256, 64), None),
    ("KaimingUniform", {"nonlinearity": "leaky_relu", "negative_slope": 0.2}, (256, 64),
     None),
    ("KaimingNormal", {"fan_in": 50}, (8, 4, 5, 5), None),
])
def test_random_initializers_draw_the_jax_distribution(name, kw, shape, bound):
    """The port's draws against the JAX initializer's on the same (JAX
    layout) shape: mean and std within 5 standard errors of each other."""
    want = _np(getattr(JI, name)(**kw)(shape, "float32")).astype(np.float64)
    tp.seed(7)
    got = getattr(PI, name)(**kw)(shape, "float32")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    g = got.double().numpy()
    n = g.size
    assert abs(g.mean() - want.mean()) < 5 * want.std() * math.sqrt(2.0 / n)
    assert abs(g.std() / want.std() - 1.0) < 5 * math.sqrt(1.0 / n) + 0.01
    if bound is not None:
        assert np.abs(g).max() <= bound + 1e-6 and np.abs(want).max() <= bound + 1e-6
    tp.seed(7)
    again = getattr(PI, name)(**kw)(shape, "float32")
    assert torch.equal(again, got)
    assert not torch.equal(getattr(PI, name)(**kw)(shape, "float32"), got)


@pytest.mark.parametrize("shape", [(64, 256), (256, 64), (6, 4, 3)])
def test_orthogonal_is_orthogonal_in_the_jax_layout(shape):
    got = PI.Orthogonal(gain=1.5)(shape).reshape(shape[0], -1).double()
    want = _np(JI.Orthogonal(gain=1.5)(shape, "float32")).reshape(shape[0], -1)
    small = min(got.shape)
    gram = got.T @ got if got.shape[0] >= got.shape[1] else got @ got.T
    wgram = want.T @ want if want.shape[0] >= want.shape[1] else want @ want.T
    np.testing.assert_allclose(gram.numpy(), 2.25 * np.eye(small), atol=1e-5)
    np.testing.assert_allclose(wgram, 2.25 * np.eye(small), atol=1e-4)


def test_calculate_gain_and_the_initializer_names():
    for nl in ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu", "leaky_relu", "other"):
        assert PI.calculate_gain(nl) == pytest.approx(JI.calculate_gain(nl))
    assert PI.calculate_gain("leaky_relu", 0.3) == pytest.approx(JI.calculate_gain(
        "leaky_relu", 0.3))
    assert PI.normal is PI.Normal and PI.uniform is PI.Uniform


def test_kaiming_reads_the_jax_layouts_fan_in():
    """KaimingNormal on a Linear(256, 64): fan_in = 256 (the JAX [in, out]
    shape's first dim), std sqrt(2 / 256), in both packages; the port's
    [out, in] weight does not halve the fan."""
    tp.seed(0)
    pw = pnn.Linear(256, 64, weight_attr=PI.KaimingNormal()).weight
    with numpy_init(0):
        jw = _np(jnn.Linear(256, 64, weight_attr=JI.KaimingNormal()).weight)
    assert tuple(pw.shape) == (64, 256) and jw.shape == (256, 64)
    for std in (pw.std().item(), jw.std()):
        assert abs(std / math.sqrt(2.0 / 256) - 1.0) < 0.03


@pytest.mark.parametrize("init", ["assign", "xavier", "orthogonal"])
def test_a_non_square_linear_takes_the_jax_weight(init):
    """Assign of a JAX [in, out] array gives the transposed weight; Xavier
    and Orthogonal keep the JAX layout's fans and orthogonal axis."""
    a = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    make = {"assign": lambda I: I.Assign(a), "xavier": lambda I: I.XavierUniform(),
            "orthogonal": lambda I: I.Orthogonal()}[init]
    pw = pnn.Linear(5, 3, weight_attr=make(PI)).weight.detach()
    jw = _np(jnn.Linear(5, 3, weight_attr=make(JI)).weight)
    if init == "assign":
        np.testing.assert_array_equal(pw.numpy(), jw.T)
    elif init == "xavier":
        lim = math.sqrt(6.0 / 8)
        assert pw.abs().max().item() <= lim and np.abs(jw).max() <= lim
    else:     # [in 5, out 3]: orthonormal columns of the JAX weight, rows of the port's
        np.testing.assert_allclose((pw @ pw.T).numpy(), np.eye(3), atol=1e-5)
        np.testing.assert_allclose(jw.T @ jw, np.eye(3), atol=1e-4)


def test_set_global_initializer_reaches_biases_and_bare_parameters(global_init_restored):
    JI.set_global_initializer(JI.Constant(0.5), JI.Constant(0.3))
    PI.set_global_initializer(PI.Constant(0.5), PI.Constant(0.3))
    with numpy_init(0):
        jl = jnn.Linear(3, 4)
    pl = pnn.Linear(3, 4)
    np.testing.assert_array_equal(pl.bias.detach().numpy(), _np(jl.bias))
    assert abs(pl.weight.detach().numpy().std() - _np(jl.weight).std()) < 1.0  # default kept
    jp_ = jnn.Layer().create_parameter([2, 3])
    pp = pnn.Layer().create_parameter([2, 3])
    np.testing.assert_array_equal(pp.detach().numpy(), _np(jp_))
    np.testing.assert_array_equal(pnn.create_parameter([2], is_bias=True).detach().numpy(),
                                  _np(jnn.layer.create_parameter([2], is_bias=True)))
    JI.set_global_initializer(None)
    PI.set_global_initializer(None)
    assert float(pnn.create_parameter([3], is_bias=True).abs().sum()) == 0.0


# ---------------------------------------------------------------- ParamAttr etc.

def test_param_attr_forms():
    for P in (jnn.ParamAttr, pnn.ParamAttr):
        assert P._to_attr(None).trainable and P._to_attr(None).initializer is None
        assert P._to_attr(False) is False
        assert P._to_attr("w").name == "w"
        init = (JI if P is jnn.ParamAttr else PI).Constant(2.0)
        assert P._to_attr(init).initializer is init
        a = P(name="x")
        assert P._to_attr(a) is a
    assert tp.ParamAttr is pnn.ParamAttr and tp.create_parameter is pnn.create_parameter


def test_create_parameter_order_and_attributes():
    reg = tp.regularizer.L2Decay(0.1)
    cases = [dict(attr=pnn.ParamAttr(initializer=PI.Constant(1.0), learning_rate=0.5,
                                     regularizer=reg, trainable=False, need_clip=False,
                                     name="p0"), default_initializer=PI.Constant(2.0)),
             dict(default_initializer=PI.Constant(2.0)), dict(is_bias=True),
             dict(attr=PI.Constant(3.0), name="p3")]
    jcases = [dict(attr=jnn.ParamAttr(initializer=JI.Constant(1.0), learning_rate=0.5,
                                      regularizer=reg, trainable=False, need_clip=False,
                                      name="p0"), default_initializer=JI.Constant(2.0)),
              dict(default_initializer=JI.Constant(2.0)), dict(is_bias=True),
              dict(attr=JI.Constant(3.0), name="p3")]
    for kw, jkw in zip(cases, jcases):
        p = pnn.create_parameter([2, 3], "float32", **kw)
        j = jnn.layer.create_parameter([2, 3], "float32", **jkw)
        assert isinstance(p, pnn.Parameter) and isinstance(p, torch.nn.Parameter)
        np.testing.assert_array_equal(p.detach().numpy(), _np(j))
        assert p.trainable == j.trainable and p.requires_grad == (not j.stop_gradient)
        assert p.name == j.name and p.optimize_attr == j.optimize_attr
        assert p.regularizer is j.regularizer
    assert pnn.create_parameter([2], attr=False) is None
    p = pnn.create_parameter([4, 5], "float64")
    assert p.dtype == torch.float64 and abs(p.std().item() - math.sqrt(2 / 9)) < 0.2
    p.trainable = False
    assert not p.requires_grad and p.stop_gradient


class _JNet(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(3, 2)
        self.block = jnn.Sequential(jnn.Linear(2, 2), jnn.ReLU())


class _PNet(pnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = pnn.Linear(3, 2)
        self.block = pnn.Sequential(pnn.Linear(2, 2), pnn.ReLU())


def test_layer_methods_match_the_jax_layer():
    with numpy_init(0):
        j = _JNet()
    p = _PNet()
    assert isinstance(p, torch.nn.Module) and isinstance(pnn.Linear(2, 2), pnn.Layer)
    assert not isinstance(torch.nn.Linear(2, 2), pnn.Layer)     # torch is left alone
    assert [n for n, _ in p.named_sublayers()] == [n for n, _ in j.named_sublayers()]
    assert [n for n, _ in p.named_sublayers(include_self=True)] == \
        [n for n, _ in j.named_sublayers(include_self=True)]
    assert len(p.sublayers()) == len(j.sublayers()) == 4
    assert p.full_name() == "_pnet" and j.full_name() == "_jnet"
    w = p.create_parameter([2, 2], default_initializer=PI.Constant(1.5))
    assert isinstance(w, pnn.Parameter) and float(w.sum()) == 6.0
    assert p.add_parameter("extra", w) is w and "extra" in dict(p.named_parameters())
    sub = pnn.Linear(2, 1)
    assert p.add_sublayer(7, sub) is sub and p._modules["7"] is sub
    t = p.create_tensor(dtype="float64")
    assert t.dtype == torch.float64 and t.shape == ()
    state = {k: _np(v) for k, v in j.state_dict().items()}
    state = {k: (v.T if k.endswith("weight") and v.ndim == 2 else v) for k, v in state.items()}
    state["unknown"] = np.zeros(1, np.float32)
    missing, unexpected = p.set_state_dict(state)
    assert unexpected == ["unknown"] and set(missing) == {"extra", "7.weight", "7.bias"}
    np.testing.assert_array_equal(p.fc.weight.detach().numpy(), _np(j.fc.weight).T)
    assert p.astype("float64") is p and p.fc.weight.dtype == torch.float64


def test_forward_hooks_and_their_remove_helper():
    x = np.ones((1, 3), np.float32)
    seen = []
    for pkg, lin, inp in ((jnn, jnn.Linear(3, 2), jp.to_tensor(x)),
                          (pnn, pnn.Linear(3, 2), torch.from_numpy(x))):
        pre = lin.register_forward_pre_hook(lambda l, i: (i[0] * 2,))
        post = lin.register_forward_post_hook(lambda l, i, o: o + 1)
        assert isinstance(pre, pkg.layer.HookRemoveHelper)
        a = _np(lin(inp))
        pre.remove()
        post.remove()
        b = _np(lin(inp))
        seen.append((a, b, _np(lin.weight), _np(lin.bias)))
    for (a, b, w, bias), transpose in zip(seen, (False, True)):
        w = w.T if transpose else w
        np.testing.assert_allclose(a, 2 * x @ w + bias + 1, rtol=1e-6)
        np.testing.assert_allclose(b, x @ w + bias, rtol=1e-6)


def _attr_layers(pkg, I):
    c = I.Constant(0.5)
    A = pkg.ParamAttr
    return {
        "Linear": lambda: pkg.Linear(3, 4, weight_attr=A(initializer=c), bias_attr=False),
        "Linear_frozen": lambda: pkg.Linear(3, 4, weight_attr=A(trainable=False),
                                            bias_attr=A(initializer=I.Constant(0.1))),
        "Conv2D": lambda: pkg.Conv2D(2, 3, 3, weight_attr=A(initializer=c),
                                     bias_attr=A(initializer=I.Constant(-1.0))),
        "Conv2DTranspose": lambda: pkg.Conv2DTranspose(2, 4, 3, groups=2,
                                                       weight_attr=A(initializer=c),
                                                       bias_attr=False),
        "Embedding": lambda: pkg.Embedding(5, 3, padding_idx=1, weight_attr=A(initializer=c)),
        "BatchNorm2D": lambda: pkg.BatchNorm2D(3, weight_attr=A(initializer=c,
                                                                trainable=False)),
        "LayerNorm": lambda: pkg.LayerNorm(4, weight_attr=c, bias_attr=False),
        "GroupNorm": lambda: pkg.GroupNorm(2, 4, bias_attr=A(initializer=c)),
        "InstanceNorm2D": lambda: pkg.InstanceNorm2D(3, weight_attr=False),
        "RMSNorm": lambda: pkg.RMSNorm(4, weight_attr=c),
        "PReLU": lambda: pkg.PReLU(3, weight_attr=A(initializer=c, trainable=False)),
        "Bilinear": lambda: pkg.Bilinear(2, 3, 4, weight_attr=c, bias_attr=False),
        "HSigmoidLoss": lambda: pkg.HSigmoidLoss(3, 5, weight_attr=c),
        "Linear_assign": lambda: pkg.Linear(2, 3, weight_attr=I.Assign(
            np.arange(6, dtype=np.float32).reshape(2, 3))),
    }


@pytest.mark.parametrize("which", list(_attr_layers(pnn, PI)))
def test_param_attr_gives_the_jax_layers_parameters(which):
    """weight_attr / bias_attr with an initializer, trainable=False and False
    for no parameter: the same parameters (values; the Linear transposed)
    and the same trainability as the JAX layer's."""
    with numpy_init(0):
        j = _attr_layers(jnn, JI)[which]()
    p = _attr_layers(pnn, PI)[which]()
    jparams = dict(j.named_parameters())
    pparams = dict(p.named_parameters())
    assert set(pparams) == set(jparams)
    for n, jw in jparams.items():
        pw = pparams[n]
        assert pw.requires_grad == (not jw.stop_gradient), n
        jv = _np(jw)
        if which.startswith("Linear") and n == "weight":
            jv = jv.T
        if which == "Linear_frozen" and n == "weight":
            assert pw.shape == jv.shape
            continue
        np.testing.assert_array_equal(pw.detach().numpy(), jv, err_msg=n)


def test_layer_state_from_jax_refuses_what_it_cannot_place():
    with numpy_init(0):
        j = jnn.Sequential(jnn.Linear(3, 4), jnn.Conv2D(2, 2, 3))
    state = {k: _np(v) for k, v in j.state_dict().items()}
    p = layer_state_from_jax(pnn.Sequential(pnn.Linear(3, 4), pnn.Conv2D(2, 2, 3)), state)
    np.testing.assert_array_equal(p[0].weight.detach().numpy(), state["0.weight"].T)
    np.testing.assert_array_equal(p[1].weight.detach().numpy(), state["1.weight"])
    with pytest.raises(ValueError, match="lacks"):
        layer_state_from_jax(pnn.Sequential(pnn.Linear(3, 4)), state)
    with pytest.raises(ValueError, match="does not fit"):
        layer_state_from_jax(pnn.Sequential(pnn.Linear(3, 4), pnn.Conv2D(2, 2, 2)), state)


# ---------------------------------------------------------------- the layers

def _carry(j, p):
    layer_state_from_jax(p, {k: _np(v) for k, v in j.state_dict().items()})
    return p


def _run_pair(j, p, inputs, grad=True, tol=VAL):
    """Both layers on the numpy ``inputs`` (None passes): outputs, and the
    gradients of sum(out * w) w.r.t. the float inputs and the parameters."""
    jin = [None if a is None else _jt(a, grad and a.dtype.kind == "f") for a in inputs]
    pin = [None if a is None else torch.from_numpy(a.copy()).requires_grad_(
        grad and a.dtype.kind == "f") for a in inputs]
    jout, pout = j(*jin), p(*pin)
    assert_same(pout, jout, tol)
    if not grad:
        return
    jo = jout[0] if isinstance(jout, tuple) else jout
    po = pout[0] if isinstance(pout, tuple) else pout
    w = np.random.RandomState(9).standard_normal(tuple(jo.shape)).astype(np.float32)
    jl = jp.sum(jp.multiply(jo, jp.to_tensor(w)))
    pl = (po * torch.from_numpy(w)).sum()
    jparams = [(n, q) for n, q in j.named_parameters() if not q.stop_gradient]
    pparams = dict(p.named_parameters())
    jx = [t for t in jin if t is not None and not t.stop_gradient]
    px = [t for t in pin if t is not None and t.requires_grad]
    jg = jp.grad(jl, jx + [q for _, q in jparams], allow_unused=True)
    pg = torch.autograd.grad(pl, px + [pparams[n] for n, _ in jparams], allow_unused=True)
    for i, (g, want) in enumerate(zip(pg, jg)):
        if want is None:
            assert g is None or not g.abs().max().item(), i
            continue
        assert_same(g, want, GRAD, f"grad[{i}]")


def _f(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


# (layer, args, kwargs, build inputs(rng), grad); every layer in eval
LAYER_CASES = [
    ("Bilinear", (3, 4, 2), {}, lambda r: [_f(r, 5, 3), _f(r, 5, 4)], True),
    ("CosineSimilarity", (), {"axis": -1}, lambda r: [_f(r, 4, 6), _f(r, 4, 6)], True),
    ("Dropout2D", (0.4,), {}, lambda r: [_f(r, 2, 3, 4, 4)], True),
    ("Dropout3D", (0.4,), {}, lambda r: [_f(r, 2, 3, 2, 2, 2)], True),
    ("AlphaDropout", (0.4,), {}, lambda r: [_f(r, 4, 5)], True),
    ("Fold", ([5, 6], 3), {"strides": 1, "paddings": 1}, lambda r: [_f(r, 2, 18, 30)], True),
    ("Unfold", (3,), {"strides": 2}, lambda r: [_f(r, 2, 2, 7, 6)], True),
    ("Pad1D", ([1, 2],), {"mode": "reflect"}, lambda r: [_f(r, 2, 3, 5)], True),
    ("Pad2D", ([1, 0, 2, 1],), {"value": 0.5}, lambda r: [_f(r, 1, 2, 3, 4)], True),
    ("Pad3D", ([1, 1, 0, 1, 1, 0],), {"mode": "replicate"}, lambda r: [_f(r, 1, 2, 2, 3, 3)], True),
    ("ZeroPad2D", ([2, 1, 0, 1],), {}, lambda r: [_f(r, 1, 2, 3, 3)], True),
    ("PairwiseDistance", (), {}, lambda r: [_f(r, 4, 5), _f(r, 4, 5)], True),
    ("PairwiseDistance", (1.0,), {"keepdim": True}, lambda r: [_f(r, 4, 5), _f(r, 4, 5)],
     True),
    ("PixelShuffle", (2,), {}, lambda r: [_f(r, 1, 8, 2, 3)], True),
    ("SpectralNorm", ((4, 3, 2),), {"dim": 1, "power_iters": 3}, lambda r: [_f(r, 4, 3, 2)],
     True),
    ("Upsample", (), {"size": [7, 5], "mode": "bilinear"}, lambda r: [_f(r, 1, 2, 4, 6)],
     True),
    ("Upsample", (), {"scale_factor": 2, "mode": "nearest"}, lambda r: [_f(r, 1, 2, 3, 3)],
     True),
    ("UpsamplingBilinear2D", (), {"size": [3, 9]}, lambda r: [_f(r, 1, 2, 6, 4)], True),
    ("UpsamplingNearest2D", (), {"scale_factor": 3}, lambda r: [_f(r, 1, 2, 2, 2)], True),
    ("GroupNorm", (2, 6), {}, lambda r: [_f(r, 2, 6, 3, 3)], True),
    ("InstanceNorm1D", (3,), {}, lambda r: [_f(r, 2, 3, 7)], True),
    ("InstanceNorm2D", (3,), {"bias_attr": False}, lambda r: [_f(r, 2, 3, 4, 4)], True),
    ("InstanceNorm3D", (2,), {}, lambda r: [_f(r, 1, 2, 3, 3, 3)], True),
    ("LocalResponseNorm", (3,), {}, lambda r: [_f(r, 2, 5, 3, 3)], True),
    ("RMSNorm", (6,), {}, lambda r: [_f(r, 2, 3, 6)], True),
    ("CTCLoss", (), {"blank": 0}, lambda r: [_f(r, 9, 2, 4), np.array([[1, 2], [3, 3]], I64),
                                             np.array([9, 7], I64), np.array([2, 2], I64)],
     True),
    ("CosineEmbeddingLoss", (), {"margin": 0.2},
     lambda r: [_f(r, 4, 5), _f(r, 4, 5), np.array([1, -1, -1, 1], I64)], True),
    ("HSigmoidLoss", (4, 6), {}, lambda r: [_f(r, 3, 4), np.array([0, 5, 2], I64)], True),
    ("HingeEmbeddingLoss", (), {"margin": 0.7},
     lambda r: [_f(r, 3, 4), np.where(r.rand(3, 4) > 0.5, 1, -1).astype(I64)], True),
    ("MarginRankingLoss", (), {"margin": 0.1, "reduction": "sum"},
     lambda r: [_f(r, 6), _f(r, 6), np.sign(_f(r, 6))], True),
    ("Conv1DTranspose", (3, 2, 3), {"stride": 2, "padding": 1},
     lambda r: [_f(r, 2, 3, 5)], True),
    ("Conv2DTranspose", (4, 6, 3), {"stride": 2, "groups": 2, "output_padding": 1},
     lambda r: [_f(r, 1, 4, 3, 3)], True),
    ("Conv3DTranspose", (2, 3, 2), {"stride": 2, "bias_attr": False},
     lambda r: [_f(r, 1, 2, 2, 3, 2)], True),
]


@pytest.mark.parametrize("case", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYER_CASES)])
def test_layer_matches_jax(case):
    name, args, kw, build, grad = case
    with numpy_init(3):
        j = getattr(jnn, name)(*args, **kw)
    p = _carry(j, getattr(pnn, name)(*args, **kw))
    j.eval()
    p.eval()
    _run_pair(j, p, build(np.random.RandomState(4)), grad)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_layers_match_jax(nd):
    shape = {1: (2, 3, 8), 2: (2, 2, 6, 4), 3: (1, 2, 4, 4, 2)}[nd]
    x = np.random.RandomState(nd).standard_normal(shape).astype(np.float32)
    pool_j = getattr(jnn, f"MaxPool{nd}D")(2, return_mask=True)
    pool_p = getattr(pnn, f"MaxPool{nd}D")(2, return_mask=True)
    jv, ji = pool_j(jp.to_tensor(x))
    pv, pi = pool_p(torch.from_numpy(x))
    np.testing.assert_array_equal(pi.numpy(), _np(ji))
    _run_pair(getattr(jnn, f"MaxUnPool{nd}D")(2), getattr(pnn, f"MaxUnPool{nd}D")(2),
              [_np(jv), _np(ji)])


def test_dropout_layers_draw_from_their_generator_in_training():
    x = torch.ones(8, 16, 3, 3)
    for cls in (pnn.Dropout2D, pnn.AlphaDropout):
        d = cls(0.5)
        d.generator = torch.Generator().manual_seed(5)
        a = d(x)
        d.generator = torch.Generator().manual_seed(5)
        assert torch.equal(a, d(x)) and not torch.equal(a, x)


def test_spectral_norm_layer_updates_its_vectors_as_jax():
    with numpy_init(0):
        j = jnn.SpectralNorm((3, 5), power_iters=1)
    p = _carry(j, pnn.SpectralNorm((3, 5), power_iters=1))
    w = np.random.RandomState(2).standard_normal((3, 5)).astype(np.float32)
    for _ in range(3):
        assert_same(p(torch.from_numpy(w)), j(jp.to_tensor(w)), VAL)
    assert_same(p.weight_u, j.weight_u, VAL)
    assert not p.weight_u.requires_grad and not p.weight_v.requires_grad


# ---------------------------------------------------------------- nn.utils

@pytest.mark.parametrize("make,dim", [("linear", 0), ("linear", 1), ("linear", -1),
                                      ("conv", 0), ("conv", 1)])
def test_weight_norm_matches_jax(make, dim):
    """weight_norm's ``dim`` is the JAX layout's: on a Linear (4 -> 6, JAX
    [4, 6], port [6, 4]) dim 0 keeps one g a JAX row (g [4])."""
    build = {"linear": lambda pkg: pkg.Linear(4, 6), "conv": lambda pkg: pkg.Conv2D(2, 3, 3)}
    with numpy_init(5):
        j = build[make](jnn)
    p = _carry(j, build[make](pnn))
    jnn.utils.weight_norm(j, dim=dim)
    pnn.utils.weight_norm(p, dim=dim)
    assert tuple(p.weight_g.shape) == tuple(j.weight_g.shape)
    assert_same(p.weight_g, j.weight_g, VAL)
    x = np.random.RandomState(6).standard_normal(
        (2, 4) if make == "linear" else (1, 2, 5, 5)).astype(np.float32)
    jv, pv = j.weight_v, p.weight_v
    jx, px = _jt(x), torch.from_numpy(x)
    jo, po = j(jx), p(px)
    assert_same(po, jo, VAL)
    w = np.random.RandomState(7).standard_normal(tuple(jo.shape)).astype(np.float32)
    jg = jp.grad(jp.sum(jp.multiply(jo, jp.to_tensor(w))), [j.weight_g, jv])
    pg = torch.autograd.grad((po * torch.from_numpy(w)).sum(), [p.weight_g, pv])
    assert_same(pg[0], jg[0], GRAD)
    want_v = _np(jg[1]).T if make == "linear" else _np(jg[1])
    np.testing.assert_allclose(pg[1].numpy(), want_v, rtol=1e-4, atol=1e-5)
    jnn.utils.remove_weight_norm(j)
    pnn.utils.remove_weight_norm(p)
    assert "weight" in dict(p.named_parameters()) and "weight_g" not in dict(
        p.named_parameters())
    want = _np(j.weight).T if make == "linear" else _np(j.weight)
    np.testing.assert_allclose(p.weight.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    assert type(p).__name__ == type(build[make](pnn)).__name__


@pytest.mark.parametrize("make", ["linear", "conv", "conv_transpose"])
def test_spectral_norm_matches_jax(make):
    """The default dim (the JAX one) on each layer type; the same u in both,
    then three calls: outputs, the u kept, the gradient of the weight."""
    build = {"linear": lambda pkg: pkg.Linear(5, 3), "conv": lambda pkg: pkg.Conv2D(2, 4, 3),
             "conv_transpose": lambda pkg: pkg.Conv2DTranspose(2, 4, 3)}
    with numpy_init(8):
        j = build[make](jnn)
    p = _carry(j, build[make](pnn))
    jnn.utils.spectral_norm(j, n_power_iterations=2)
    pnn.utils.spectral_norm(p, n_power_iterations=2)
    assert tuple(p.weight_u.shape) == tuple(j.weight_u.shape)
    with torch.no_grad():
        p.weight_u.copy_(torch.from_numpy(_np(j.weight_u)))
    x = np.random.RandomState(9).standard_normal(
        (2, 5) if make == "linear" else (1, 2, 5, 5)).astype(np.float32)
    for _ in range(3):
        jo, po = j(_jt(x)), p(torch.from_numpy(x))
        assert_same(po, jo, VAL)
    assert_same(p.weight_u, j.weight_u, VAL)
    w = np.random.RandomState(10).standard_normal(tuple(jo.shape)).astype(np.float32)
    jg = jp.grad(jp.sum(jp.multiply(j(_jt(x)), jp.to_tensor(w))), [j.weight_orig])[0]
    pg = torch.autograd.grad((p(torch.from_numpy(x)) * torch.from_numpy(w)).sum(),
                             [p.weight_orig])[0]
    want = _np(jg).T if make == "linear" else _np(jg)
    np.testing.assert_allclose(pg.numpy(), want, rtol=1e-4, atol=1e-5)


def test_parameters_to_vector_and_back():
    with numpy_init(11):
        j = jnn.Sequential(jnn.Conv2D(2, 3, 3), jnn.LayerNorm(4))
    p = _carry(j, pnn.Sequential(pnn.Conv2D(2, 3, 3), pnn.LayerNorm(4)))
    jvec = jnn.utils.parameters_to_vector(j.parameters())
    pvec = pnn.utils.parameters_to_vector(p.parameters())
    assert_same(pvec, jvec, (0, 0))
    new = np.arange(pvec.shape[0], dtype=np.float32)
    jnn.utils.vector_to_parameters(jp.to_tensor(new), j.parameters())
    pnn.utils.vector_to_parameters(torch.from_numpy(new), p.parameters())
    for (n, a), (_, b) in zip(p.named_parameters(), j.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), _np(b), err_msg=n)
    with pytest.raises(ValueError, match="does not match"):
        pnn.utils.vector_to_parameters(torch.zeros(3), p.parameters())


def test_the_nn_namespace_is_the_jax_ones():
    import paddle_tpu_torch.nn.functional as TNF

    assert pnn.functional is TNF and pnn.initializer is PI
    assert tp.nn.functional.gather_tree is pnn.layers.decode.gather_tree
    item17 = {"RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU", "RNNCellBase", "SimpleRNNCell",
              "LSTMCell", "GRUCell", "BeamSearchDecoder", "Decoder", "dynamic_decode"}
    ref = {n for n in dir(jnn) if not n.startswith("_")}
    assert sorted(n for n in ref - item17 if not hasattr(pnn, n)) == []
