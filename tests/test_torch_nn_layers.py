"""The port's nn layers and functional ops (paddle_tpu_torch/nn/layers/,
ops/nn_functional.py, ops/activation.py) against the JAX package's on the
same numpy-seeded inputs and weights.

Tolerances: f32 outputs and losses at 1e-4 x max(1, max|ref|) (``_close``);
gradients at 1e-4 relative to their largest entry; running statistics at
1e-4 relative. bf16 under auto_cast: the output dtype only (the ops' amp
lists are the JAX package's).
"""
import collections

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as pnn
from torch_numpy_init import numpy_init
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.ops import nn_functional as PF

TOL = 1e-4

torch.set_num_threads(1)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= bound, f"{what}: max |err| {err} > {bound}"


def _grad_close(got, want, what=""):
    _close(got, want, tol=TOL, what=what) if np.abs(want).max() <= 1 else \
        _close(got / np.abs(want).max(), want / np.abs(want).max(), what=what)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _cotangent(shape):
    """A fixed cotangent for an output of ``shape`` (the same in both
    packages): sin(0, 1, 2, ...) laid out in that shape."""
    return np.sin(np.arange(int(np.prod(shape)), dtype=np.float64)).reshape(
        shape).astype(np.float32)


def _jax_ref(fn, arrays, wrt=()):
    """``fn`` (JAX Tensors in, a Tensor or a tuple of them out) on numpy
    ``arrays`` in one jitted program: its outputs, and the gradients of
    sum(out[0] x _cotangent) with respect to the arrays at indices ``wrt``.
    One compile a case instead of one an op (the eager dispatcher's)."""
    from paddle_tpu.core.tensor import Tensor

    def outs(args):
        out = fn(*[Tensor(a) for a in args])
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o._data for o in out)

    def loss(diff, args):
        args = list(args)
        for i, d in zip(wrt, diff):
            args[i] = d
        res = outs(args)
        g = jax.numpy.sin(jax.numpy.arange(res[0].size, dtype=jax.numpy.float32))
        return (res[0] * g.reshape(res[0].shape)).sum(), res

    args = [jax.numpy.asarray(a) for a in arrays]
    if not wrt:
        return [np.asarray(o) for o in jax.jit(outs)(args)], []
    (_, res), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        [args[i] for i in wrt], args)
    return [np.asarray(o) for o in res], [np.asarray(g) for g in grads]


def _port_grads(out, tensors):
    """Gradients of sum(out x _cotangent) with respect to ``tensors``."""
    return torch.autograd.grad((out * torch.from_numpy(_cotangent(tuple(out.shape)))).sum(),
                               tensors)


def _both(arr, grad=False):
    """(JAX tensor, torch tensor) of one numpy array."""
    j = paddle.to_tensor(arr, stop_gradient=not grad)
    t = torch.from_numpy(np.array(arr))
    if grad:
        t.requires_grad_()
    return j, t


# ---------------------------------------------------------------- conv

CONV2D_CASES = {  # name: (x shape, weight shape, kwargs)
    "pad_int": ((2, 4, 9, 9), (6, 4, 3, 3), dict(padding=1)),
    "pad_per_dim": ((2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 2])),
    "pad_per_side": ((2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[1, 0, 2, 1], stride=2)),
    "pad_pairs": ((2, 4, 9, 8), (6, 4, 3, 3), dict(padding=[(0, 1), (2, 0)])),
    "same_stride2": ((2, 4, 9, 8), (6, 4, 4, 3), dict(padding="SAME", stride=2)),
    "valid_dilated": ((2, 4, 11, 11), (6, 4, 3, 3), dict(padding="VALID", dilation=2)),
    "groups_bias": ((2, 4, 8, 8), (6, 2, 3, 3), dict(padding=1, groups=2, bias=True)),
    "nhwc": ((2, 7, 6, 4), (3, 3, 4, 5), dict(padding=1, data_format="NHWC", bias=True)),
    "nhwc_same": ((2, 7, 6, 4), (3, 2, 4, 5), dict(padding="SAME", stride=2,
                                                  data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(CONV2D_CASES))
def test_conv2d_matches_jax_with_gradients(case):
    xs, ws, kw = CONV2D_CASES[case]
    kw = dict(kw)
    rng = _rng(1)
    arrays = [rng.randn(*xs).astype(np.float32), rng.randn(*ws).astype(np.float32)]
    if kw.pop("bias", False):
        arrays.append(rng.randn(ws[-1] if kw.get("data_format") == "NHWC" else ws[0]
                                ).astype(np.float32))
    (jo,), jgrads = _jax_ref(lambda *a: JF.conv2d(*a, **kw), arrays,
                             wrt=tuple(range(len(arrays))))
    pt = [torch.from_numpy(a).requires_grad_() for a in arrays]
    po = PF.conv2d(*pt, **kw)
    _close(po, jo, what=case)
    for name, g, j in zip("xwb", _port_grads(po, pt), jgrads):
        _grad_close(g.numpy(), j, what=f"{case} d{name}")


@pytest.mark.parametrize("nd", [1, 3])
def test_conv1d_and_conv3d_match_jax(nd):
    rng = _rng(2)
    xs = (2, 3) + (7,) * nd
    ws = (4, 3) + (3,) * nd
    jx, px = _both(rng.randn(*xs).astype(np.float32))
    jw, pw = _both(rng.randn(*ws).astype(np.float32))
    fj, fp = (JF.conv1d, PF.conv1d) if nd == 1 else (JF.conv3d, PF.conv3d)
    for kw in (dict(padding=1, stride=2), dict(padding="SAME"), dict(padding=[1, 0] * nd)):
        _close(fp(px, pw, **kw), fj(jx, jw, **kw), what=f"conv{nd}d {kw}")


# ---------------------------------------------------------------- pools

POOL_CASES = {  # name: (op, kwargs)
    "max_k3s2p1": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    "max_same": ("max_pool2d", dict(kernel_size=3, stride=2, padding="SAME")),
    "max_ceil_mode": ("max_pool2d", dict(kernel_size=2, stride=2, ceil_mode=True)),
    "max_pad_per_side": ("max_pool2d", dict(kernel_size=3, stride=2, padding=[0, 2, 1, 0])),
    "max_nhwc": ("max_pool2d", dict(kernel_size=3, stride=2, padding=1, data_format="NHWC")),
    "avg_exclusive": ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1)),
    "avg_inclusive": ("avg_pool2d", dict(kernel_size=3, stride=2, padding=1,
                                         exclusive=False)),
    "avg_same_exclusive": ("avg_pool2d", dict(kernel_size=4, stride=3, padding="SAME")),
    "avg_same_inclusive": ("avg_pool2d", dict(kernel_size=4, stride=3, padding="SAME",
                                              exclusive=False)),
    "avg_ceil_mode": ("avg_pool2d", dict(kernel_size=3, stride=2, ceil_mode=True)),
    "avg_nhwc": ("avg_pool2d", dict(kernel_size=2, stride=2, data_format="NHWC")),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax_with_gradients(case):
    """ceil_mode is accepted and ignored by both (the JAX op's floor length)."""
    op, kw = POOL_CASES[case]
    x = _rng(3).randn(2, 3, 9, 9).astype(np.float32)
    (jo,), (jg,) = _jax_ref(lambda a: getattr(JF, op)(a, **kw), [x], wrt=(0,))
    px = torch.from_numpy(x).requires_grad_()
    po = getattr(PF, op)(px, **kw)
    _close(po, jo, what=case)
    _grad_close(_port_grads(po, [px])[0].numpy(), jg, what=f"{case} dx")


@pytest.mark.parametrize("nd", [1, 3])
def test_pool1d_and_pool3d_match_jax(nd):
    rng = _rng(4)
    jx, px = _both(rng.randn(*((2, 3) + (7,) * nd)).astype(np.float32))
    for op in ("max", "avg"):
        for kw in (dict(kernel_size=3, stride=2, padding=1), dict(kernel_size=2)):
            name = f"{op}_pool{nd}d"
            _close(getattr(PF, name)(px, **kw), getattr(JF, name)(jx, **kw),
                   what=f"{name} {kw}")
    _close(PF.avg_pool1d(px, 3, 2, 1, exclusive=False) if nd == 1
           else PF.avg_pool3d(px, 3, 2, 1, exclusive=False),
           JF.avg_pool1d(jx, 3, 2, 1, exclusive=False) if nd == 1
           else JF.avg_pool3d(jx, 3, 2, 1, exclusive=False), what=f"avg{nd}d inclusive")


ADAPTIVE_CASES = [  # (op, input shape, output size, kwargs)
    ("adaptive_avg_pool2d", (2, 3, 8, 8), (1, 1), {}),
    ("adaptive_avg_pool2d", (2, 3, 7, 9), (3, 4), {}),
    ("adaptive_avg_pool2d", (2, 7, 9, 3), (3, 4), dict(data_format="NHWC")),
    ("adaptive_avg_pool2d", (2, 3, 7, 9), (None, 4), {}),
    ("adaptive_max_pool2d", (2, 3, 8, 8), 2, {}),
    ("adaptive_max_pool2d", (2, 3, 7, 9), (3, 4), {}),
    ("adaptive_avg_pool1d", (2, 3, 10), 4, {}),
    ("adaptive_max_pool1d", (2, 3, 10), 4, {}),
    ("adaptive_avg_pool3d", (2, 3, 5, 6, 7), (2, 3, 4), {}),
    ("adaptive_max_pool3d", (2, 3, 5, 6, 7), 2, {}),
]


@pytest.mark.parametrize("case", range(len(ADAPTIVE_CASES)))
def test_adaptive_pools_match_jax(case):
    op, shape, size, kw = ADAPTIVE_CASES[case]
    jx, px = _both(_rng(5).randn(*shape).astype(np.float32))
    _close(getattr(PF, op)(px, size, **kw), getattr(JF, op)(jx, size, **kw),
           what=f"{op} {shape} -> {size}")


# ---------------------------------------------------------------- batch norm

BN_CASES = {  # name: (x shape, data_format, training, use_global_stats)
    "nchw_train": ((4, 3, 5, 5), "NCHW", True, None),
    "nhwc_train": ((4, 5, 5, 3), "NHWC", True, None),
    "nc_train": ((6, 3), "NCHW", True, None),
    "ncl_train": ((4, 3, 7), "NCHW", True, None),
    "nchw_eval": ((4, 3, 5, 5), "NCHW", False, None),
    "global_stats_train": ((4, 3, 5, 5), "NCHW", True, True),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_output_gradients_and_running_stats_match_jax(case):
    shape, fmt, training, ugs = BN_CASES[case]
    rng = _rng(6)
    c = shape[-1] if fmt == "NHWC" else shape[1]
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w, b = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    rm0, rv0 = rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.5
    kw = dict(training=training, momentum=0.8, epsilon=1e-5, data_format=fmt,
              use_global_stats=ugs)

    def jax_bn(x, w, b, rm, rv):
        return JF.batch_norm(x, rm, rv, w, b, **kw), rm, rv   # rm, rv updated in place

    (jo, jm, jv), jgrads = _jax_ref(jax_bn, [x, w, b, rm0, rv0], wrt=(0, 1, 2))
    pt = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    pm, pv = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy())
    po = PF.batch_norm(pt[0], pm, pv, pt[1], pt[2], **kw)
    _close(po, jo, what=case)
    _close(pm, jm, what=f"{case} running mean")
    _close(pv, jv, what=f"{case} running variance")
    if training and not ugs:
        assert not np.allclose(pm.numpy(), rm0)
    else:
        np.testing.assert_array_equal(pm.numpy(), rm0)
    for name, g, j in zip("xwb", _port_grads(po, pt), jgrads):
        _grad_close(g.numpy(), j, what=f"{case} d{name}")


def test_batch_norm_layers_and_sync_conversion_match_jax():
    rng = _rng(7)
    x = rng.randn(4, 3, 6, 6).astype(np.float32)
    with numpy_init(0):
        jl = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4), jnn.ReLU())
        jb1 = jnn.BatchNorm1D(3)
    pl = pnn.Sequential(pnn.Conv2D(3, 4, 3, padding=1, device="cpu"),
                        pnn.BatchNorm2D(4, device="cpu"), pnn.ReLU())
    pl.load_state_dict(_port_state(jl))
    assert set(pl.state_dict()) == {"0.weight", "0.bias", "1.weight", "1.bias",
                                    "1._mean", "1._variance"}
    _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), what="train forward")
    for k in ("1._mean", "1._variance"):
        _close(pl.state_dict()[k], jl.state_dict()[k], what=k)
    pl.eval()
    jl.eval()
    _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), what="eval forward")
    synced = pnn.SyncBatchNorm.convert_sync_batchnorm(pl)
    assert isinstance(synced[1], pnn.SyncBatchNorm) and synced[1]._mean is pl[1]._mean
    _close(synced(torch.from_numpy(x)), jl(paddle.to_tensor(x)), what="synced eval")
    b1 = pnn.BatchNorm1D(3, device="cpu")
    x1 = rng.randn(5, 3, 4).astype(np.float32)
    _close(b1(torch.from_numpy(x1)), jb1(paddle.to_tensor(x1)), what="BatchNorm1D")
    _close(b1._variance, jb1._variance, what="BatchNorm1D variance")


def _port_state(jlayer):
    from paddle_tpu_torch.models import state_from_jax

    return state_from_jax({k: np.asarray(v._data) for k, v in jlayer.state_dict().items()})


# ---------------------------------------------------------------- losses

def _ce_inputs(rng, shape=(6, 5)):
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int64)
    labels.reshape(-1)[[1, 4]] = -100
    return logits, labels


CE_CASES = {  # name: kwargs
    "mean_ignore": dict(),
    "sum_ignore": dict(reduction="sum"),
    "none_ignore": dict(reduction="none"),
    "ignore_7": dict(ignore_index=7),
    "weighted_mean": dict(weight=True),
    "weighted_sum": dict(weight=True, reduction="sum"),
    "soft_label": dict(soft=True),
    "soft_label_weighted": dict(soft=True, weight=True),
    "label_smoothing": dict(label_smoothing=0.1),
    "label_smoothing_weighted": dict(label_smoothing=0.2, weight=True),
    "axis1": dict(axis=1),
    "probabilities": dict(use_softmax=False),
    "label_with_class_dim": dict(label_dim=True),
}


@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax_with_gradients(case):
    kw = dict(CE_CASES[case])
    rng = _rng(8)
    shape = (3, 5, 4) if kw.get("axis") == 1 else (6, 5)
    logits, labels = _ce_inputs(rng, shape if kw.get("axis") != 1 else (3, 4, 5))
    if kw.get("axis") == 1:
        logits = np.ascontiguousarray(logits.transpose(0, 2, 1))   # classes on axis 1
    if kw.pop("soft", False):
        lab = rng.rand(*logits.shape).astype(np.float32)
        labels = lab / lab.sum(-1, keepdims=True)
        kw["soft_label"] = True
    if kw.pop("label_dim", False):
        labels = labels[..., None]
    if case == "ignore_7":
        labels = np.where(labels == -100, 7, labels)
    if kw.get("use_softmax") is False:
        e = np.exp(logits - logits.max(-1, keepdims=True))
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    w = pw = None
    if kw.pop("weight", False):
        w = rng.rand(logits.shape[-1]).astype(np.float32) + 0.5
        pw = torch.from_numpy(w)
    arrays = [logits, labels] + ([w] if pw is not None else [])
    (jo,), (jg,) = _jax_ref(
        lambda lg, lb, *wt: JF.cross_entropy(lg, lb, weight=wt[0] if wt else None, **kw),
        arrays, wrt=(0,))
    pl = torch.from_numpy(logits).requires_grad_()
    po = PF.cross_entropy(pl, torch.from_numpy(labels), weight=pw, **kw)
    _close(po, jo, what=case)
    _grad_close(_port_grads(po, [pl])[0].numpy(), jg, what=f"{case} dlogits")


def test_softmax_with_cross_entropy_and_layer_match_jax():
    rng = _rng(9)
    logits, labels = _ce_inputs(rng)
    jl, pl = _both(logits)
    jlab, plab = _both(labels[:, None])
    _close(PF.softmax_with_cross_entropy(pl, plab),
           JF.softmax_with_cross_entropy(jl, jlab), what="swce")
    lo, sm = PF.softmax_with_cross_entropy(pl, plab, return_softmax=True)
    jlo, jsm = JF.softmax_with_cross_entropy(jl, jlab, return_softmax=True)
    _close(sm, jsm, what="swce softmax")
    _close(pnn.CrossEntropyLoss(ignore_index=-100, reduction="sum")(pl, plab[:, 0]),
           jnn.CrossEntropyLoss(ignore_index=-100, reduction="sum")(jl, jlab[:, 0]),
           what="CrossEntropyLoss")


LOSS_CASES = {  # name: (port layer, JAX layer, input kind)
    "mse": (lambda: pnn.MSELoss(), lambda: jnn.MSELoss(), "regress"),
    "mse_sum": (lambda: pnn.MSELoss("sum"), lambda: jnn.MSELoss("sum"), "regress"),
    "l1": (lambda: pnn.L1Loss(), lambda: jnn.L1Loss(), "regress"),
    "smooth_l1": (lambda: pnn.SmoothL1Loss(delta=0.7), lambda: jnn.SmoothL1Loss(delta=0.7),
                  "regress"),
    "nll": (lambda: pnn.NLLLoss(), lambda: jnn.NLLLoss(), "logprob"),
    "nll_weighted": ("weighted", "weighted", "logprob"),
    "nll_none": (lambda: pnn.NLLLoss(reduction="none"),
                 lambda: jnn.NLLLoss(reduction="none"), "logprob"),
    "bce": (lambda: pnn.BCELoss(), lambda: jnn.BCELoss(), "prob"),
    "bce_logits": (lambda: pnn.BCEWithLogitsLoss(), lambda: jnn.BCEWithLogitsLoss(),
                   "logit"),
    "bce_logits_pos_weight": ("pos_weight", "pos_weight", "logit"),
    "kl_div": (lambda: pnn.KLDivLoss(), lambda: jnn.KLDivLoss(), "kl"),
    "kl_div_batchmean": (lambda: pnn.KLDivLoss("batchmean"),
                         lambda: jnn.KLDivLoss("batchmean"), "kl"),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_layers_match_jax_with_gradients(case):
    pmk, jmk, kind = LOSS_CASES[case]
    rng = _rng(10)
    x = rng.randn(6, 5).astype(np.float32)
    if kind == "regress":
        y = rng.randn(6, 5).astype(np.float32)
    elif kind == "logprob":
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
        y = rng.randint(0, 5, (6,)).astype(np.int64)
        y[2] = -100
    elif kind == "prob":
        x = 1 / (1 + np.exp(-x))
        y = (rng.rand(6, 5) > 0.5).astype(np.float32)
    elif kind == "logit":
        y = (rng.rand(6, 5) > 0.5).astype(np.float32)
    else:
        x = x - np.log(np.exp(x).sum(-1, keepdims=True))
        t = rng.rand(6, 5)
        y = (t / t.sum(-1, keepdims=True)).astype(np.float32)
    x = x.astype(np.float32)
    extra = {}
    if pmk == "weighted":
        extra["w"] = rng.rand(5).astype(np.float32) + 0.5
        pl = pnn.NLLLoss(torch.from_numpy(extra["w"]))
        jmk = lambda w: jnn.NLLLoss(w)  # noqa: E731
    elif pmk == "pos_weight":
        extra["w"] = rng.rand(5).astype(np.float32) + 0.5
        extra["pw"] = rng.rand(5).astype(np.float32) + 0.5
        pl = pnn.BCEWithLogitsLoss(torch.from_numpy(extra["w"]),
                                   pos_weight=torch.from_numpy(extra["pw"]))
        jmk = lambda w, pw: jnn.BCEWithLogitsLoss(w, pos_weight=pw)  # noqa: E731
    else:
        pl = pmk()
    (jo,), (jg,) = _jax_ref(lambda a, b, *e: jmk(*e)(a, b), [x, y, *extra.values()],
                            wrt=(0,))
    px = torch.from_numpy(x).requires_grad_()
    po = pl(px, torch.from_numpy(y))
    _close(po, jo, what=case)
    _grad_close(_port_grads(po, [px])[0].numpy(), jg, what=f"{case} dx")


# ---------------------------------------------------------------- activations

ACTIVATIONS = {  # name: constructor args
    "ReLU": (), "ReLU6": (), "Sigmoid": (), "Tanh": (), "SiLU": (), "Swish": (),
    "Mish": (), "Hardswish": (), "Hardsigmoid": (), "Softsign": (), "Tanhshrink": (),
    "LogSigmoid": (), "GELU": (), "ELU": (0.7,), "SELU": (), "CELU": (1.3,),
    "LeakyReLU": (0.1,), "Hardtanh": (-0.5, 0.8), "Hardshrink": (0.4,),
    "Softshrink": (0.3,), "Softplus": (2.0, 5.0), "ThresholdedReLU": (0.6,),
    "Maxout": (2,), "GLU": (), "Softmax": (1,), "LogSoftmax": (), "Softmax2D": (),
    "Silu": (), "RReLU": (),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_layers_match_jax(name):
    args = ACTIVATIONS[name]
    x = (_rng(11).randn(2, 4, 3, 6) * 3).astype(np.float32)
    jl, pl = getattr(jnn, name)(*args), getattr(pnn, name)(*args)
    if name == "RReLU":       # eval: the mean slope (training draws differ by design)
        jl.eval()
        pl.eval()
    _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), what=name)


def test_gelu_tanh_and_prelu_match_jax():
    x = (_rng(12).randn(2, 4, 3, 3) * 3).astype(np.float32)
    _close(pnn.GELU(approximate=True)(torch.from_numpy(x)),
           jnn.GELU(approximate=True)(paddle.to_tensor(x)), what="gelu tanh")
    jp, pp = jnn.PReLU(4, 0.1), pnn.PReLU(4, 0.1, device="cpu")
    _close(pp(torch.from_numpy(x)), jp(paddle.to_tensor(x)), what="prelu")


# ---------------------------------------------------------------- common, containers

def test_linear_embedding_flatten_identity_match_jax():
    rng = _rng(13)
    with numpy_init(3):
        jlin, jemb = jnn.Linear(6, 4), jnn.Embedding(10, 4, padding_idx=2)
    plin = pnn.Linear(6, 4, device="cpu")
    plin.load_state_dict({"weight": torch.from_numpy(jlin.weight.numpy().T.copy()),
                          "bias": torch.from_numpy(jlin.bias.numpy())})
    x = rng.randn(3, 6).astype(np.float32)
    _close(plin(torch.from_numpy(x)), jlin(paddle.to_tensor(x)), what="Linear")
    pemb = pnn.Embedding(10, 4, padding_idx=2, device="cpu")
    assert not pemb.weight[2].any()
    pemb.load_state_dict(_port_state(jemb))
    ids = np.array([[1, 2, 3], [2, 9, 0]], np.int64)
    _close(pemb(torch.from_numpy(ids)), jemb(paddle.to_tensor(ids)), what="Embedding")
    y = rng.randn(2, 3, 4, 5).astype(np.float32)
    for a, b in ((1, -1), (0, 2), (2, 3)):
        _close(pnn.Flatten(a, b)(torch.from_numpy(y)),
               jnn.Flatten(a, b)(paddle.to_tensor(y)), what=f"Flatten {a} {b}")
    _close(pnn.Identity(3, k=1)(torch.from_numpy(y)), y, what="Identity")


def test_dropout_layer_eval_identity_and_train_statistics():
    d = pnn.Dropout(0.25)
    d.generator = torch.Generator().manual_seed(0)
    x = torch.ones(200, 100)
    y = d(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01 and torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    d.generator = torch.Generator().manual_seed(0)
    assert torch.equal(d(x), y)
    d.eval()
    assert torch.equal(d(x), x)


def test_sequential_indexes_by_int_slice_and_name_as_jax():
    jseq = jnn.Sequential(("a", jnn.ReLU()), ("b", jnn.Tanh()), ("c", jnn.Sigmoid()))
    pseq = pnn.Sequential(("a", pnn.ReLU()), ("b", pnn.Tanh()), ("c", pnn.Sigmoid()))
    assert list(pseq._modules) == list(jseq._sub_layers) == ["a", "b", "c"]
    assert isinstance(pseq["b"], pnn.Tanh) and isinstance(pseq[-1], pnn.Sigmoid)
    sl = pseq[1:]
    assert isinstance(sl, pnn.Sequential) and list(sl._modules) == ["0", "1"]
    assert list(jseq[1:]._sub_layers) == ["0", "1"]
    od = pnn.Sequential(collections.OrderedDict([("x", pnn.ReLU()), ("y", pnn.Tanh())]))
    assert list(od._modules) == ["x", "y"] and len(od) == 2
    x = (_rng(14).randn(3, 4) * 2).astype(np.float32)
    _close(pseq(torch.from_numpy(x)), jseq(paddle.to_tensor(x)), what="Sequential")
    ll = pnn.LayerList([pnn.ReLU(), pnn.Tanh()])
    ll.append(pnn.Sigmoid())
    ll.insert(0, pnn.Identity())
    assert [type(m).__name__ for m in ll] == ["Identity", "ReLU", "Tanh", "Sigmoid"]
    assert isinstance(ll[1:3], pnn.LayerList) and len(ll[1:3]) == 2
    ld = pnn.LayerDict({"r": pnn.ReLU()})
    ld["t"] = pnn.Tanh()
    assert "t" in ld and list(ld.keys()) == ["r", "t"] and isinstance(ld.pop("r"), pnn.ReLU)
    pl = pnn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and len(list(torch.nn.Module.parameters(pl))) == 2


CONV_LAYERS = {  # name: (port ctor, JAX ctor, input shape)
    "Conv1D": (lambda d: pnn.Conv1D(3, 4, 3, stride=2, padding=1, device=d),
               lambda: jnn.Conv1D(3, 4, 3, stride=2, padding=1), (2, 3, 9)),
    "Conv2D": (lambda d: pnn.Conv2D(4, 6, 3, padding=1, groups=2, bias_attr=False, device=d),
               lambda: jnn.Conv2D(4, 6, 3, padding=1, groups=2, bias_attr=False),
               (2, 4, 7, 7)),
    "Conv3D": (lambda d: pnn.Conv3D(2, 3, 3, padding="SAME", device=d),
               lambda: jnn.Conv3D(2, 3, 3, padding="SAME"), (1, 2, 5, 5, 5)),
    "MaxPool2D": (lambda d: pnn.MaxPool2D(3, 2, 1), lambda: jnn.MaxPool2D(3, 2, 1),
                  (2, 3, 8, 8)),
    "AvgPool2D": (lambda d: pnn.AvgPool2D(3, 2, 1, exclusive=False),
                  lambda: jnn.AvgPool2D(3, 2, 1, exclusive=False), (2, 3, 8, 8)),
    "AvgPool1D": (lambda d: pnn.AvgPool1D(2), lambda: jnn.AvgPool1D(2), (2, 3, 8)),
    "MaxPool3D": (lambda d: pnn.MaxPool3D(2), lambda: jnn.MaxPool3D(2), (1, 2, 4, 4, 4)),
    "AdaptiveAvgPool2D": (lambda d: pnn.AdaptiveAvgPool2D((1, 1)),
                          lambda: jnn.AdaptiveAvgPool2D((1, 1)), (2, 3, 5, 5)),
    "AdaptiveMaxPool2D": (lambda d: pnn.AdaptiveMaxPool2D(2),
                          lambda: jnn.AdaptiveMaxPool2D(2), (2, 3, 5, 5)),
    "LayerNorm": (lambda d: pnn.LayerNorm([4, 5], device=d), lambda: jnn.LayerNorm([4, 5]),
                  (2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(CONV_LAYERS))
def test_conv_pool_and_norm_layers_match_jax(name):
    pmk, jmk, shape = CONV_LAYERS[name]
    with numpy_init(5):
        jl = jmk()
    pl = pmk("cpu")
    if any(True for _ in pl.parameters()):
        pl.load_state_dict(_port_state(jl))
        assert [tuple(p.shape) for p in pl.parameters()] == \
            [tuple(p.shape) for p in jl.parameters()]
    x = _rng(15).randn(*shape).astype(np.float32)
    _close(pl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), what=name)


def test_conv2d_layer_default_init_and_channel_last():
    """The JAX layers' N(0, sqrt(2 / fan_in)) weights and zero bias; at NHWC
    the layer computes what the NCHW layer computes on the transposed
    input."""
    torch.manual_seed(0)
    c = pnn.Conv2D(16, 32, 3, device="cpu")
    assert abs(c.weight.std().item() - (2.0 / (16 * 9)) ** 0.5) < 0.01
    assert not c.bias.any()
    nhwc = pnn.Conv2D(16, 32, 3, padding=1, data_format="NHWC", device="cpu")
    nchw = pnn.Conv2D(16, 32, 3, padding=1, device="cpu")
    nchw.load_state_dict(nhwc.state_dict())
    x = torch.randn(2, 16, 5, 5)
    torch.testing.assert_close(nhwc(x.permute(0, 2, 3, 1)),
                               nchw(x).permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_amp_lists_apply_to_the_new_ops():
    x = torch.randn(2, 3, 8, 8)
    conv = pnn.Conv2D(3, 4, 3, padding=1, device="cpu")
    bn = pnn.BatchNorm2D(4, device="cpu")
    with auto_cast(dtype="bfloat16"):
        y = conv(x)
        z = bn(y)
        loss = PF.cross_entropy(z.flatten(1), torch.tensor([1, 2]))
    assert y.dtype == torch.bfloat16          # conv2d: white list
    assert z.dtype == torch.float32           # batch_norm: black list
    assert loss.dtype == torch.float32 and bn._mean.dtype == torch.float32


def test_a_layer_built_alone_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn.Conv2D(3, 4, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pnn.BatchNorm2D(4)
    assert pnn.Linear(3, 4, device="cpu").weight.device.type == "cpu"
    pnn.ReLU()    # no parameters: nothing to place
