"""BASELINE config 3's model on the port: paddle_tpu_torch.models.ernie's
ErnieForPretraining (ernie_tiny) against the JAX package's on the same
weights (carried by models/convert.py) and numpy-seeded inputs with token
types, a padding mask, MLM labels at 15% (-100 elsewhere) and NSP labels,
at dropout 0; and one TrainStepEngine step under ZeRO against the JAX
engine's. The multi-rank check (dp 2 x sharding 2 in 4 gloo ranks) is in
tests/test_torch_vision.py, which spawns the one world both use.

Tolerances: f32 hidden states, pooled output and loss at 1e-4 x max(1,
max|ref|); gradients at 1e-4 relative to the tensor's largest entry; AdamW
parameters after the step atol 5 x lr with at most 0.1% of all entries
more than 1e-5 apart (tests/test_torch_accum.py's rule: the key bias's
exact gradient is 0, so Adam moves it by lr x the sign of its rounding).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_vision_workers as W
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.jit import functional_call
from paddle_tpu.models.ernie import ErnieForPretraining as JaxErnie
from paddle_tpu.models.ernie import ernie_tiny as jax_ernie_tiny
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.distributed import TrainStepEngine
from paddle_tpu_torch.models import (BertForPretraining, ErnieForPretraining, ErnieModel,
                                     bert_base, ernie_base, ernie_tiny, gather_to_jax,
                                     load_jax_state, state_from_jax)
from torch_numpy_init import numpy_init

TOL = 1e-4

torch.set_num_threads(1)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), f"{what}: |err| {err}"


def _rel_close(got, want, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - np.asarray(want)).max())
    assert err <= TOL * scale + 1e-12, f"{what}: |err| {err} vs max|ref| {scale}"


def _jax_model(**cfg):
    set_hybrid_communicate_group(None)
    with numpy_init(0):
        return JaxErnie(jax_ernie_tiny(**cfg))


def _np_state(jm):
    return {k: np.asarray(v._data) for k, v in jm.state_dict().items()}


def _port_model(state, **cfg):
    return load_jax_state(ErnieForPretraining(ernie_tiny(**cfg), device="cpu"), state)


def test_hidden_states_pooled_loss_and_gradients_match_jax():
    jm = _jax_model()
    state = _np_state(jm)
    pm = _port_model(state)
    batch = [t.numpy() for t in W.ernie_batch()]
    pnames = [n for n, _ in jm.named_parameters()]

    def f(params, ids, labels, types, mask, nsp):
        t = [Tensor(a) for a in (ids, labels, types, mask, nsp)]
        hidden, pooled = functional_call(jm.ernie, {k[len("ernie."):]: v for k, v in
                                                    params.items() if k.startswith("ernie.")},
                                         t[0], t[2], t[3])
        loss = functional_call(jm, params, t[0], t[1], t[2], t[3], t[4])
        return loss._data, (hidden._data, pooled._data)

    (jloss, (jh, jp)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {n: state[n] for n in pnames}, *batch)
    tb = [torch.from_numpy(a) for a in batch]
    ph, pp = pm.ernie(tb[0], tb[2], tb[3])
    _close(ph, np.asarray(jh), what="hidden states")
    _close(pp, np.asarray(jp), what="pooled")
    ploss = pm(*tb)
    _close(ploss, float(jloss), what="MLM + NSP loss")
    ploss.backward()
    want = state_from_jax({n: np.asarray(g) for n, g in jgrads.items()})
    assert set(want) == {n for n, _ in pm.named_parameters()}
    for n, p in pm.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, n
        _rel_close(p.grad, want[n].numpy(), what=f"grad {n}")
    # the MLM loss alone (no NSP labels): the mean over every position
    _close(pm(tb[0], tb[1], tb[2], tb[3]),
           float(jax.jit(lambda p, *a: functional_call(jm, p, *[Tensor(x) for x in a])._data)(
               {n: state[n] for n in pnames}, *batch[:4])), what="MLM loss")


def test_one_zero_engine_step_matches_the_jax_engine():
    jm = _jax_model()
    state = _np_state(jm)
    lr = W.ERNIE_LR
    jeng = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters(),
                                                weight_decay=0.01),
                     hcg=HybridCommunicateGroup(dp_degree=1, devices=jax.devices()[:1]))
    batch = W.ernie_batch()
    jloss = float(jeng.step(*[paddle.to_tensor(t.numpy()) for t in batch]).item())
    pm = _port_model(state)
    peng = TrainStepEngine(pm, popt.AdamW(learning_rate=lr, parameters=pm.named_parameters(),
                                          weight_decay=0.01), zero_update=True)
    ploss = peng.step(*batch).item()
    assert peng._zero_opt is not None        # the flat-shard update ran
    assert ploss == pytest.approx(jloss, rel=TOL)
    want = state_from_jax({n: np.asarray(a) for n, a in jeng.params.items()})
    apart = total = 0
    for n, p in pm.named_parameters():
        g, w = p.detach().numpy(), want[n].numpy()
        np.testing.assert_allclose(g, w, atol=5 * lr, rtol=0, err_msg=n)
        apart += int(np.sum(np.abs(g - w) > 1e-5))
        total += w.size
    assert apart <= 1e-3 * total, (apart, total)


def test_a_port_state_runs_in_the_jax_model():
    """gather_to_jax of a stepped port model -> the JAX model's state: the
    same eval loss."""
    pm = ErnieForPretraining(ernie_tiny(), device="cpu", seed=4)
    batch = W.ernie_batch()
    TrainStepEngine(pm, popt.SGD(learning_rate=0.1, parameters=pm.named_parameters())
                    ).step(*batch)
    jm = _jax_model()
    back = gather_to_jax([pm.state_dict()])
    assert set(back) == set(_np_state(jm))
    pm.eval()
    jm.eval()
    with torch.no_grad():
        ploss = pm(*batch).item()
    jloss = jax.jit(lambda p, *a: functional_call(jm, p, *[Tensor(x) for x in a])._data)(
        back, *[t.numpy() for t in batch])
    assert ploss == pytest.approx(float(jloss), rel=TOL)


def test_recompute_dropout_and_masks():
    """Recompute gives the same loss and gradients; dropout (the published
    0.1, 0.1) draws from the model's generator, repeats from its seed and
    is off in eval; a mask of all ones equals no mask."""
    batch = W.ernie_batch()
    a = ErnieForPretraining(ernie_tiny(), device="cpu", seed=1)
    b = ErnieForPretraining(ernie_tiny(use_recompute=True), device="cpu", seed=1)
    la, lb = a(*batch), b(*batch)
    la.backward()
    lb.backward()
    assert la.item() == lb.item()
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-6, atol=1e-7, msg=n)
    d1 = ErnieForPretraining(ernie_tiny(dropout=0.1, attention_dropout=0.1), device="cpu",
                             seed=2)
    d2 = ErnieForPretraining(ernie_tiny(dropout=0.1, attention_dropout=0.1), device="cpu",
                             seed=2)
    first = d1(*batch).item()
    assert first == d2(*batch).item() and first != d1(*batch).item()
    d1.eval()
    assert d1(*batch).item() == d1(*batch).item()
    ids, labels, types, mask, nsp = batch
    a.eval()
    with torch.no_grad():
        assert a(ids, labels, types, torch.ones_like(mask), nsp).item() == pytest.approx(
            a(ids, labels, types, None, nsp).item(), rel=1e-6)


def test_configs_aliases_and_devices(monkeypatch):
    cfg = ernie_base()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.ffn_hidden_size, cfg.max_seq_len, cfg.type_vocab_size,
            cfg.dropout, cfg.attention_dropout) == (40000, 768, 12, 12, 3072, 512, 4, 0.1, 0.1)
    assert bert_base().vocab_size == 30522 and bert_base().type_vocab_size == 2
    assert BertForPretraining is ErnieForPretraining
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForPretraining(ernie_tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieModel(ernie_tiny())
    m = ErnieModel(ernie_tiny(), device="cpu")
    h, pooled = m(torch.zeros(2, 16, dtype=torch.long))
    assert h.shape == (2, 16, 128) and pooled.shape == (2, 128)


def test_more_than_one_model_parallel_rank_raises(monkeypatch):
    from paddle_tpu_torch.models import ernie

    monkeypatch.setattr(ernie, "mp_info", lambda *a: (None, 0, 2))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        ErnieForPretraining(ernie_tiny(), device="cpu")
