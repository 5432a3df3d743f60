"""paddle_tpu_torch/incubate/quantization.py against the JAX package's
incubate/quantization.py, on the CPU.

Weights and inputs come from numpy seeds; the JAX models from
``paddle.seed(0)``, their weights (float or quantized) carried into the port
by models/convert.py. The port stores ``_w_int8`` ``[out, in]`` where the
JAX package stores ``[in, out]``. Tolerances:

- ``quantize_weight``, the int8 activations and the int32 accumulators of
  the dynamic and static paths: bit for bit (the JAX package's int8
  activations and accumulators are read back through its own matmuls: an
  identity weight gives ``x_q x scale``, and rows whose scale is 1 give the
  accumulator exactly in f32);
- the three matmuls at f32: 1e-6 x max|ref| (sums in another order); under
  bf16 ``auto_cast`` the output dtype and 1e-2 x max|ref|;
- gpt_tiny's scoring logits, each mode: 2e-6 at every position (observed
  ~1e-6), but where an activation quantized at run time (dynamic_int8,
  static_int8) lies within an ulp of a rounding boundary: the two packages'
  f32 sums in another order then round it to neighbouring int8 steps, and
  that position's logits move by up to ~1e-2 (seen at 1 position in 24 for
  1 of 6 prompts). There, at most 1 position in 8 may exceed 2e-6 and
  none 5e-2 (``_assert_logits_agree``); greedy tokens through ``generate``
  and both ServingEngine layouts: equal;
- QAT: the reference's 30 Adam steps, losses and activation scales rtol
  1e-5, then ``convert``'s outputs within 1e-6 x max|ref|; ``fake_quant``
  within 2 ulps (XLA contracts the grid's multiply and subtract), its
  gradient exactly; through the engines on gpt_tiny the activation scales
  frozen in both, exactly, the first loss rtol 1e-5 and the later ones
  rtol 5e-4: after a step the weights differ in the last bits, and a
  fake-quantized activation within them of a rounding boundary takes the
  neighbouring step (seen: ~6e-5 and ~1.6e-4 at the third and fourth);
- PTQ: the recorded scales rtol 1e-6, static_int8 outputs within 1e-6 x
  max|ref|.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import elastic as jelastic
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.incubate import quantization as JQ
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxServing
from paddle_tpu_torch import framework
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.distributed import TrainStepEngine, elastic
from paddle_tpu_torch.incubate import quantization as Q
from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny, load_jax_state,
                                     state_from_jax)
from paddle_tpu_torch.models.gpt import Linear
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.serving import ServingEngine

LOGITS_TOL = 2e-6
FLIP_TOL = 5e-2      # a position whose activation rounds to the neighbouring int8 step
QAT_LOSS_RTOL = 5e-4  # ... the same flips in a fake-quantized gpt_tiny after a step


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _jt(a):
    return paddle.to_tensor(a)


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().float().numpy()


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


def _assert_qat_losses(got, want):
    """A QAT trajectory of gpt_tiny through the engines: the first loss rtol
    1e-5, every one QAT_LOSS_RTOL (module docstring)."""
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=QAT_LOSS_RTOL)


def _assert_logits_agree(got, want, mode):
    """[b, s, V] logits: within LOGITS_TOL at every position (weight-only),
    or at all but 1 in 8 positions and within FLIP_TOL at those (module
    docstring)."""
    err = np.abs(got - want).max(-1)
    if mode == "weight_only_int8":
        assert err.max() <= LOGITS_TOL, err.max()
    else:
        assert (err > LOGITS_TOL).mean() <= 1 / 8 and err.max() <= FLIP_TOL, err


def test_the_module_exports_the_reference_surface():
    assert Q.__all__ == JQ.__all__
    from paddle_tpu_torch import incubate
    assert incubate.quantization is Q


@pytest.mark.parametrize("shape", [(64, 48), (128, 384), (3, 5)])
def test_quantize_weight_is_bit_equal_with_a_zero_channel(shape):
    w = _rand(shape, 0, 0.02)          # [in, out], the JAX layout
    w[:, 1] = 0.0                      # an all-zero output channel
    w[0, 0] = 0.5 * np.abs(w[:, 0]).max() / 127 * 254   # a tie of round()
    jq, js = JQ.quantize_weight(w)
    pq, ps = Q.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert tuple(pq.shape) == shape[::-1] and tuple(ps.shape) == (shape[1],)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps[1] == 0 and not pq[1].any()


def _operands(k=64, n=48, m=(4, 7), seed=0, bias=True):
    x = _rand((*m, k), seed)
    w = _rand((k, n), seed + 1, 0.05)
    jq, js = JQ.quantize_weight(w)
    b = _rand((n,), seed + 2, 0.1) if bias else None
    return x, np.array(jq), np.array(js), b


def _both(mode, x, q, s, b, act=None):
    """(JAX's output, the port's) of mode's matmul on the same operands."""
    jb = None if b is None else _jt(b)
    pb = None if b is None else torch.from_numpy(b)
    pw = torch.from_numpy(np.ascontiguousarray(q.T))
    if mode == "static_int8":
        jo = JQ.static_int8_matmul(_jt(x), _jt(q), _jt(s), act, bias=jb)
        po = Q.static_int8_matmul(torch.from_numpy(x), pw, torch.from_numpy(s),
                                  torch.tensor(act, dtype=torch.float32), bias=pb)
    else:
        jfn = getattr(JQ, mode.replace("_int8", "_int8_matmul"))
        pfn = getattr(Q, mode.replace("_int8", "_int8_matmul"))
        jo = jfn(_jt(x), _jt(q), _jt(s), bias=jb)
        po = pfn(torch.from_numpy(x), pw, torch.from_numpy(s), bias=pb)
    return jo, po


MODES = ["weight_only_int8", "dynamic_int8", "static_int8"]


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_the_matmuls_match_jax_at_f32(mode, bias):
    x, q, s, b = _operands(bias=bias)
    jo, po = _both(mode, x, q, s, b, act=0.021)
    assert po.dtype == torch.float32 and tuple(po.shape) == (4, 7, 48)
    _close(po.numpy(), _np(jo), 1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_the_matmuls_match_jax_under_bf16_autocast(mode):
    x, q, s, b = _operands(seed=3)
    with paddle.amp.auto_cast(dtype="bfloat16"):
        jo, _ = _both(mode, x, q, s, b, act=0.021)
    with auto_cast(dtype="bfloat16"):
        _, po = _both(mode, x, q, s, b, act=0.021)
    assert str(jo._data.dtype) == "bfloat16" and po.dtype == torch.bfloat16
    _close(po.float().numpy(), np.asarray(jo._data, np.float32), 1e-2)


@pytest.mark.parametrize("k", [64, 768])
def test_the_int8_activations_are_bit_equal(k):
    """JAX's int8 activations read back through its matmul with an identity
    weight and unit scales: out = x_q x row scale (dynamic), x_q x act
    (static); x_q = round(out / scale) is exact for |x_q| <= 127."""
    x = _rand((9, k), 4)
    x[2] = 0.0                                     # a zero row: scale 0, divisor 1
    eye, ones = np.eye(k, dtype=np.int8), np.ones(k, np.float32)
    xs = np.abs(x).max(1, keepdims=True) / np.float32(127.0)
    out = _np(JQ.dynamic_int8_matmul(_jt(x), _jt(eye), _jt(ones)))
    jx_q = np.round(out / np.where(xs == 0, 1, xs)).astype(np.int8)
    px_q, pxs = Q._quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(pxs.numpy(), xs)
    np.testing.assert_array_equal(px_q.numpy(), jx_q)

    act = np.float32(0.013)
    out = _np(JQ.static_int8_matmul(_jt(x), _jt(eye), _jt(ones), float(act)))
    jx_q = np.round(out / act).astype(np.int8)
    px_q, _ = Q._quantize_static(torch.from_numpy(x), torch.tensor(act))
    np.testing.assert_array_equal(px_q.numpy(), jx_q)
    assert np.abs(jx_q).max() == 127               # the clip is reached


@pytest.mark.parametrize("k,n", [(64, 48), (768, 2304), (3072, 768)])
def test_the_int32_accumulators_are_bit_equal(k, n):
    """Rows whose abs-max is 127 have scale 1 (dynamic), and act_scale 1
    (static): with unit weight scales JAX's f32 output is its int32
    accumulator, exact below 2**24."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-127, 127, (8, k)).astype(np.float32)
    x[:, 0] = 127.0 * np.sign(rng.randn(8)).astype(np.float32)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)      # [in, out]
    ones = np.ones(n, np.float32)
    pw = torch.from_numpy(np.ascontiguousarray(w.T))
    for jout, (x_q, _) in (
            (JQ.dynamic_int8_matmul(_jt(x), _jt(w), _jt(ones)),
             Q._quantize_rows(torch.from_numpy(x))),
            (JQ.static_int8_matmul(_jt(x * 1.5), _jt(w), _jt(ones), 1.0),
             Q._quantize_static(torch.from_numpy(x * 1.5), torch.tensor(1.0)))):
        want = _np(jout)
        assert np.abs(want).max() < 2 ** 24
        acc = Q._int8_mm(x_q, pw)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), want.astype(np.int64))


# ------------------------------------------------------------ on gpt_tiny ---

def _jax_model(tied=True):
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny(tie_word_embeddings=tied))
    jm.eval()
    return jm


def _state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _port(state, tied=True):
    return load_jax_state(GPTForPretraining(gpt_tiny(tie_word_embeddings=tied),
                                            device="cpu"), state)


def _ids(b=2, s=16, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, s)).astype(np.int64)


def _pair(mode="weight_only_int8", tied=True, calib=None):
    """The JAX gpt_tiny and the port's on its float weights, each quantized
    by its own package (static_int8 through PostTrainingQuantization on
    ``calib``). Returns (jm, pm, jax ptq scales, port ptq scales)."""
    jm = _jax_model(tied)
    pm = _port(_state(jm), tied).eval()
    js = ps = None
    if mode == "static_int8":
        jptq, pptq = JQ.PostTrainingQuantization(jm), Q.PostTrainingQuantization(pm)
        for ids in calib:
            jptq.collect(_jt(ids))
            pptq.collect(torch.from_numpy(ids))
        js, ps = dict(jptq.scales), dict(pptq.scales)
        jptq.convert(mode)
        pptq.convert(mode)
    else:
        JQ.quantize_model(jm, mode)
        Q.quantize_model(pm, mode)
    return jm, pm, js, ps


@pytest.mark.parametrize("mode", MODES)
def test_the_quantized_models_score_as_jax(mode):
    jm, pm, js, ps = _pair(mode, calib=[_ids(2, 16, 7), _ids(2, 16, 8)])
    assert isinstance(pm.gpt.blocks[0].attn.qkv_proj, Q.QuantizedLinear)
    assert pm.gpt.blocks[1].mlp.fc2.mode == mode
    assert all(n.startswith(("ln1.", "ln2.")) for n, _ in pm.gpt.blocks[0].named_parameters())
    jsd, psd = _state(jm), pm.state_dict()
    assert set(jsd) == set(psd)
    for n in jsd:
        if n.endswith("_w_int8"):
            assert psd[n].dtype == torch.int8
            np.testing.assert_array_equal(psd[n].numpy(), jsd[n].T, err_msg=n)
    if mode == "static_int8":
        assert set(js) == set(ps) and len(ps) == 8
        np.testing.assert_allclose([ps[n] for n in sorted(ps)],
                                   [js[n] for n in sorted(js)], rtol=1e-6)
    for ids in [_ids(2, 32, 1)] + [_ids(1, 24, seed) for seed in range(6)]:
        with torch.no_grad():
            got = pm(torch.from_numpy(ids)).numpy()
        _assert_logits_agree(got, _np(jm(_jt(ids))), mode)


def test_a_jax_quantized_state_loads_through_convert():
    jm = _jax_model()
    JQ.quantize_model(jm, "dynamic_int8")
    pm = GPTForPretraining(gpt_tiny(), device="cpu", seed=3).eval()
    Q.quantize_model(pm, "dynamic_int8")
    load_jax_state(pm, _state(jm))
    conv = state_from_jax(_state(jm))
    assert tuple(conv["gpt.blocks.0.mlp.fc1._w_int8"].shape) == (512, 128)
    assert conv["gpt.blocks.0.mlp.fc1._scale"].shape == (512,)
    for seed in range(4):
        ids = _ids(1, 24, seed)
        with torch.no_grad():
            got = pm(torch.from_numpy(ids)).numpy()
        _assert_logits_agree(got, _np(jm(_jt(ids))), "dynamic_int8")


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_weight_only_generate_tokens_equal_jax(tied):
    jm, pm, _, _ = _pair(tied=tied)
    if not tied:
        assert isinstance(pm.lm_head, Q.QuantizedLinear)
    ids = _ids(2, 8)
    want = jm.generate(_jt(ids), max_new_tokens=8, temperature=0).numpy()
    got = pm.generate(torch.from_numpy(ids), max_new_tokens=8, temperature=0).numpy()
    np.testing.assert_array_equal(got, want)
    beam = pm.generate(torch.from_numpy(ids), max_new_tokens=4, num_beams=2).numpy()
    np.testing.assert_array_equal(
        beam, jm.generate(_jt(ids), max_new_tokens=4, num_beams=2).numpy())


def test_bf16_decode_keeps_int8_weights_and_f32_scales(monkeypatch):
    _, pm, _, _ = _pair("dynamic_int8", tied=False)
    with auto_cast(dtype="bfloat16"):
        params, cache_dtype = pm._decode_weights()
    assert cache_dtype == torch.bfloat16
    assert params["gpt.blocks.0.attn.qkv_proj._w_int8"].dtype == torch.int8
    assert params["lm_head._w_int8"].dtype == torch.int8
    assert params["gpt.blocks.0.attn.qkv_proj._scale"].dtype == torch.float32
    assert params["gpt.wte.weight"].dtype == torch.bfloat16
    assert "lm_head.weight" not in params
    seen = []
    real = Q.dynamic_int8_matmul

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out.dtype)
        return out

    monkeypatch.setattr(Q, "dynamic_int8_matmul", spy)
    with auto_cast(dtype="bfloat16"):
        out = pm.generate(torch.from_numpy(_ids(2, 8)), max_new_tokens=3, temperature=0)
    assert out.shape == (2, 11) and len(seen) == 3 * 9 and set(seen) == {torch.bfloat16}


def _engine(model, cls, paged, **kw):
    args = dict(slot_count=3, ladder=(8, 16, 32), max_new_cap=8, max_seq_len=48,
                steps_per_dispatch=4)
    if paged:
        args.update(kv_layout="paged", kv_page_tokens=8)
    args.update(kw)
    return cls(model, **args)


def _serve(eng, prompts, n=6):
    reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0) for p in prompts]
    eng.run()
    return [r.tokens for r in reqs]


PROMPTS = [np.random.RandomState(3).randint(0, 1024, (n,)).astype(np.int64)
           for n in (5, 9, 12, 3, 17)]


@pytest.mark.parametrize("mode", ["weight_only_int8", "dynamic_int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_the_serving_engines_on_quantized_models_equal_jax(mode, paged):
    jm, pm, _, _ = _pair(mode)
    want = _serve(_engine(jm, JaxServing, paged), PROMPTS)
    got = _serve(_engine(pm, ServingEngine, paged), PROMPTS)
    assert got == want
    gen = pm.generate(torch.from_numpy(PROMPTS[1][None]), max_new_tokens=6,
                      temperature=0)[0, 9:].tolist()
    assert got[1] == gen


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_refresh_params_serves_the_requantized_weights(paged):
    jm = _jax_model()
    pm = _port(_state(jm)).eval()
    jeng, peng = _engine(jm, JaxServing, paged), _engine(pm, ServingEngine, paged)
    assert _serve(peng, PROMPTS[:2]) == _serve(jeng, PROMPTS[:2])
    JQ.quantize_model(jm, "dynamic_int8")
    Q.quantize_model(pm, "dynamic_int8")
    jeng.refresh_params()
    peng.refresh_params()
    assert isinstance(peng._net.gpt.blocks[0].mlp.fc1, Q.QuantizedLinear)
    got = _serve(peng, PROMPTS)
    assert got == _serve(jeng, PROMPTS)
    assert got == _serve(_engine(pm, ServingEngine, paged), PROMPTS)


# ------------------------------------------------------------------- QAT ---

@pytest.mark.parametrize("kw", [{}, {"channel_axis": 0}, {"scale": 0.02},
                                {"scale": 0.0}, {"bits": 4}])
def test_fake_quant_forward_and_straight_through_gradient(kw):
    a = _rand((6, 8), 20)
    jkw, pkw = dict(kw), dict(kw)
    if "scale" in kw:
        jkw["scale"] = _jt(np.float32(kw["scale"]))
        pkw["scale"] = torch.tensor(kw["scale"], dtype=torch.float32)
    if "channel_axis" in kw:
        jkw["channel_axis"] = 1 - kw["channel_axis"]
    jx = _jt(a.T.copy() if "channel_axis" in kw else a)
    jx.stop_gradient = False
    jy = JQ.fake_quant(jx, **jkw)
    jy.sum().backward()
    px = torch.from_numpy(a).requires_grad_()
    py = Q.fake_quant(px, **pkw)
    py.sum().backward()
    want = _np(jy).T if "channel_axis" in kw else _np(jy)
    np.testing.assert_array_max_ulp(py.detach().numpy(), want, maxulp=2)
    np.testing.assert_array_equal(px.grad.numpy(), np.ones_like(a))
    np.testing.assert_array_equal(_np(jx.grad), np.ones_like(_np(jx)))
    qmax = 2 ** (kw.get("bits", 8) - 1) - 1
    assert len(np.unique(py.detach().numpy())) <= 2 * qmax + 1


def _jax_seq():
    paddle.seed(0)
    return paddle.nn.Sequential(paddle.nn.Linear(8, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 1))


def _port_seq(jnet):
    net = torch.nn.Sequential(Linear(8, 16), torch.nn.ReLU(), Linear(16, 1))
    with torch.no_grad():
        for i in (0, 2):
            net[i].weight.copy_(torch.from_numpy(np.asarray(jnet[i].weight._data).T))
            net[i].bias.copy_(torch.from_numpy(np.asarray(jnet[i].bias._data)))
    return net


def test_the_reference_qat_run_matches_jax():
    """tests/test_quantization.py's QAT run in both packages: 30 Adam steps,
    then convert to int8."""
    jnet = _jax_seq()
    net = _port_seq(jnet)
    jqat, qat = JQ.ImperativeQuantAware(), Q.ImperativeQuantAware()
    jqat.quantize(jnet)
    qat.quantize(net)
    assert isinstance(net[0], Q.QATLinear) and len(list(net.parameters())) == 4
    x, target = _rand((32, 8), 21), _rand((32, 1), 22)
    jopt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=jnet.parameters())
    opt = Adam(learning_rate=1e-2, parameters=list(net.parameters()))
    jnet.train()
    net.train()
    jl, pl, jsc, psc = [], [], [], []
    px, pt = torch.from_numpy(x), torch.from_numpy(target)
    for _ in range(30):
        loss = ((jnet(_jt(x)) - _jt(target)) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.item()))
        jsc.append([float(_np(jnet[i]._act_scale)) for i in (0, 2)])
        ploss = ((net(px) - pt) ** 2).mean()
        ploss.backward()
        opt.step()
        opt.clear_grad()
        pl.append(ploss.item())
        psc.append([float(net[i]._act_scale) for i in (0, 2)])
    assert jl[-1] < 0.5 * jl[0] and pl[-1] < 0.5 * pl[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    np.testing.assert_allclose(psc, jsc, rtol=1e-5)

    jnet.eval()
    net.eval()
    for mode in ("weight_only_int8", "dynamic_int8", "static_int8"):
        jc = _jax_seq()
        pc = _port_seq(jc)
        JQ.ImperativeQuantAware().quantize(jc)
        Q.ImperativeQuantAware().quantize(pc)
        jc.set_state_dict(jnet.state_dict())
        pc.load_state_dict(net.state_dict())
        jqat.convert(jc, mode)
        qat.convert(pc, mode)
        assert pc[0].mode == mode and isinstance(pc[2], Q.QuantizedLinear)
        if mode == "static_int8":
            assert float(pc[0]._act_scale) == float(net[0]._act_scale) > 0
        with torch.no_grad():
            _close(pc(px).numpy(), _np(jc(_jt(x))), 1e-6)


def _qat_gpt_pair():
    jm = _jax_model()
    pm = _port(_state(jm))
    JQ.ImperativeQuantAware().quantize(jm)
    Q.ImperativeQuantAware().quantize(pm)
    jm.train()
    pm.train()
    return jm, pm


def _train_batch(seed=0):
    ids = _ids(2, 32, seed)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    return ids, labels


def test_qat_act_scales_stay_frozen_inside_the_train_engines():
    """One eager training forward calibrates the scales; 3 engine steps move
    neither package's (the JAX engine traces the model)."""
    jm, pm = _qat_gpt_pair()
    ids, labels = _train_batch()
    jm(_jt(ids), _jt(labels))
    pm(torch.from_numpy(ids), torch.from_numpy(labels))
    names = [n for n, _ in pm.named_modules() if isinstance(_, Q.QATLinear)]
    assert len(names) == 8

    jsub, psub = dict(jm.named_sublayers()), dict(pm.named_modules())

    def jscales():
        return [float(_np(jsub[n]._act_scale)) for n in names]

    def pscales():
        return [float(psub[n]._act_scale) for n in names]

    js0, ps0 = jscales(), pscales()
    np.testing.assert_allclose(ps0, js0, rtol=1e-5)
    assert min(ps0) > 0
    hcg = HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1])
    jeng = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=1e-3,
                                                parameters=jm.parameters()), hcg=hcg)
    peng = TrainStepEngine(pm, AdamW(1e-3, parameters=pm.named_parameters()))
    jl = [float(jeng.step(_jt(ids), _jt(labels)).item()) for _ in range(3)]
    pl = [peng.step(torch.from_numpy(ids), torch.from_numpy(labels)).item()
          for _ in range(3)]
    _assert_qat_losses(pl, jl)
    assert pl[-1] < pl[0]
    assert pscales() == ps0 and jscales() == js0
    # eagerly, a training forward moves them again
    pm(torch.from_numpy(ids), torch.from_numpy(labels))
    assert pscales() != ps0


def test_qat_under_recompute_updates_only_outside_the_engine():
    """A recomputed block replays in the backward under its forward's trace
    flag: inside the engine the scales stay frozen."""
    _, pm = _qat_gpt_pair()
    for blk in pm.gpt.blocks:
        blk.use_recompute = True
    ids, labels = (torch.from_numpy(a) for a in _train_batch(1))
    peng = TrainStepEngine(pm, AdamW(1e-3, parameters=pm.named_parameters()))
    qs = [m for m in pm.modules() if isinstance(m, Q.QATLinear)]
    peng.step(ids, labels)
    assert all(float(q._act_scale) == 0 for q in qs)
    pm(ids, labels).backward()
    assert all(float(q._act_scale) > 0 for q in qs)


def test_a_qat_model_converts_and_generates():
    jm, pm = _qat_gpt_pair()
    ids, labels = _train_batch(2)
    jm(_jt(ids), _jt(labels))
    pm(torch.from_numpy(ids), torch.from_numpy(labels))
    jm.eval()
    pm.eval()
    prompt = _ids(2, 8, 4)
    np.testing.assert_array_equal(
        pm.generate(torch.from_numpy(prompt), max_new_tokens=6, temperature=0).numpy(),
        jm.generate(_jt(prompt), max_new_tokens=6, temperature=0).numpy())
    JQ.quantize_model(jm)          # over a QAT model: through the inner Linear
    Q.quantize_model(pm)
    assert isinstance(pm.gpt.blocks[0].attn.qkv_proj, Q.QuantizedLinear)
    np.testing.assert_array_equal(
        pm.generate(torch.from_numpy(prompt), max_new_tokens=6, temperature=0).numpy(),
        jm.generate(_jt(prompt), max_new_tokens=6, temperature=0).numpy())


def test_an_untied_qat_head_trains_as_jax():
    jm = _jax_model(tied=False)
    pm = _port(_state(jm), tied=False)
    JQ.ImperativeQuantAware().quantize(jm)
    Q.ImperativeQuantAware().quantize(pm)
    assert isinstance(pm.lm_head, Q.QATLinear)
    jm.train()
    pm.train()
    ids, labels = _train_batch(3)
    jloss = jm(_jt(ids), _jt(labels))
    ploss = pm(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(ploss.item(), float(jloss.item()), rtol=1e-5)
    ploss.backward()
    assert pm.lm_head.inner.weight.grad.abs().max() > 0
    np.testing.assert_allclose(float(pm.lm_head._act_scale),
                               float(_np(jm.lm_head._act_scale)), rtol=1e-5)


def test_a_qat_checkpoint_round_trips_and_crosses_to_jax(tmp_path):
    """The engine's checkpoint of a QAT model: QATLinear's inner weights are
    found as Linear weights (JAX layout), a fresh QAT engine resumes bit for
    bit, and the JAX engine resumes the port's checkpoint."""
    jm, pm = _qat_gpt_pair()
    ids, labels = _train_batch(5)
    pe = TrainStepEngine(pm, AdamW(1e-3, parameters=pm.named_parameters()))
    assert "gpt.blocks.0.attn.qkv_proj.inner.weight" in elastic.linear_weights(pe)
    [pe.step(torch.from_numpy(ids), torch.from_numpy(labels)) for _ in range(2)]
    elastic.CheckpointManager(str(tmp_path), async_save=False).save(pe, block=True)
    want = [pe.step(torch.from_numpy(ids), torch.from_numpy(labels)).item()
            for _ in range(2)]

    pm2 = GPTForPretraining(gpt_tiny(), device="cpu", seed=9)
    Q.ImperativeQuantAware().quantize(pm2)
    pe2 = TrainStepEngine(pm2, AdamW(1e-3, parameters=pm2.named_parameters()))
    assert elastic.restore_latest(pe2, str(tmp_path)) == 2
    got = [pe2.step(torch.from_numpy(ids), torch.from_numpy(labels)).item()
           for _ in range(2)]
    assert got == want

    hcg = HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1])
    je = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=1e-3,
                                              parameters=jm.parameters()), hcg=hcg)
    assert jelastic.restore_latest(je, str(tmp_path)) == 2
    jl = [float(je.step(_jt(ids), _jt(labels)).item()) for _ in range(2)]
    _assert_qat_losses(jl, want)


# ------------------------------------------------------------------- PTQ ---

def test_ptq_records_jax_scales_and_restores_training_flags():
    jnet = _jax_seq()
    net = _port_seq(jnet)
    net.train()
    net[1].eval()                      # a deliberately frozen submodule
    jnet.train()
    jptq, ptq = JQ.PostTrainingQuantization(jnet), Q.PostTrainingQuantization(net)
    assert len(ptq._hooks) == 2
    for seed in (50, 51):
        x = _rand((8, 8), seed, 1.0 + seed - 50)
        jptq.collect(_jt(x))
        ptq.collect(torch.from_numpy(x))
    assert net.training and net[0].training and not net[1].training
    assert set(ptq.scales) == set(jptq.scales) == {"0", "2"}
    for n in ptq.scales:
        np.testing.assert_allclose(ptq.scales[n], jptq.scales[n], rtol=1e-6)
    jq, q = jptq.convert("static_int8"), ptq.convert("static_int8")
    assert not ptq._hooks and not net[0]._forward_pre_hooks
    assert float(q[0]._act_scale) == np.float32(ptq.scales["0"])
    x = _rand((8, 8), 52, 1.5)
    with torch.no_grad():
        _close(q(torch.from_numpy(x)).numpy(), _np(jq(_jt(x))), 1e-6)


def test_the_buffers_survive_save_and_load(tmp_path):
    _, pm, _, _ = _pair("static_int8", calib=[_ids(2, 16, 7)])
    sd = pm.state_dict()
    assert not any("_w_int8" in n or "_scale" in n for n, _ in pm.named_parameters())
    assert sum(n.endswith("._w_int8") for n in sd) == 8
    assert sum(n.endswith("._act_scale") for n in sd) == 8
    path = str(tmp_path / "q.pdparams")
    framework.save(sd, path)
    back = framework.load(path, device="cpu")
    for n, t in sd.items():
        assert back[n].dtype == t.dtype and torch.equal(back[n], t), n
    theirs = paddle.load(path)             # the JAX package reads the file
    np.testing.assert_array_equal(np.asarray(theirs["gpt.blocks.0.mlp.fc1._w_int8"]._data),
                                  sd["gpt.blocks.0.mlp.fc1._w_int8"].numpy())
    fresh = _pair("static_int8", calib=[_ids(2, 16, 8)])[1]
    fresh.load_state_dict(back)
    ids = torch.from_numpy(_ids(1, 16, 9))
    with torch.no_grad():
        assert torch.equal(fresh(ids), pm(ids))


def test_the_reference_errors():
    lin = torch.nn.Linear(4, 4)
    for call in (lambda: Q.quantize_model(torch.nn.Sequential(lin), mode="static_int8"),
                 lambda: Q.QuantizedLinear.from_linear(lin, mode="static_int8"),
                 lambda: Q.QuantizedLinear.from_linear(lin, mode="int4"),
                 lambda: Q.PostTrainingQuantization(torch.nn.Sequential(lin)).convert(
                     "static_int8")):
        with pytest.raises(ValueError):
            call()
    jlin = paddle.nn.Linear(4, 4)
    for mine, theirs in (
            (lambda: Q.quantize_model(torch.nn.Linear(4, 4), mode="static_int8"),
             lambda: JQ.quantize_model(jlin, mode="static_int8")),
            (lambda: Q.QuantizedLinear.from_linear(lin, mode="int4"),
             lambda: JQ.QuantizedLinear.from_linear(jlin, mode="int4"))):
        with pytest.raises(ValueError) as a:
            mine()
        with pytest.raises(ValueError) as b:
            theirs()
        assert str(a.value) == str(b.value)
    root = Q.quantize_model(torch.nn.Linear(8, 16))        # the root is swapped
    assert isinstance(root, Q.QuantizedLinear)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16))
    Q.ImperativeQuantAware().quantize(net)
    Q.ImperativeQuantAware().quantize(net)                 # never inside a wrapper
    assert isinstance(net[0], Q.QATLinear) and type(net[0].inner) is torch.nn.Linear
