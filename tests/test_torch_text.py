"""paddle_tpu_torch.text against the JAX package's paddle_tpu.text: every
dataset's samples bit for bit (the same RandomState draws); viterbi_decode
and ViterbiDecoder on mixed lengths (paths equal, scores within 1e-6); the
FasterTokenizer over the port's build of tokenizer.cc against the JAX one
and against the Python oracle (``basic_tokenize`` + ``wordpiece_tokenize``);
and tokenizer -> ERNIE at ernie_tiny widths against the JAX encoder (1e-4
x max(1, max|ref|), tests/test_torch_ernie.py's limit).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.text as jtext
import paddle_tpu_torch as tp
import paddle_tpu_torch.text as ptext
from paddle_tpu_torch.text import faster_tokenizer as pft
from torch_api_util import on_cpu  # noqa: F401

torch.set_num_threads(1)
pytestmark = pytest.mark.usefixtures("on_cpu")

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "quick", "brown", "fox",
         "jump", "##ed", "##s", "over", "lazy", "dog", "!", ",", "a",
         "un", "##aff", "##able", "你", "好", "caf", "##e"]
EXOTIC = ["a\u1680b", "a\u205fb", "a\u2028b", "a\u2029b", "a\u2007b", "a\u200ab",
          "a\u3000b", "a\x0bb", "a\x0cb", "a\x85b",
          "\u0391\u0392 \u03b1\u03b2",       # Greek upper / lower
          "\u0416\u0423 \u0436\u0443",       # Cyrillic upper / lower
          "\u0130stanbul \u0131",              # Turkish dotted / dotless I
          "\ufb01 \ufb02 ligatures",           # fi / fl ligatures
          "caf\xe9 CAF\xc9 \xdcber",          # Latin-1 fold targets
          "\uff21\uff22\uff1a\uff23",        # fullwidth forms
          "a\u200bb", "a\ufeffb"]              # zero-width space / BOM
TEXTS = ["The QUICK brown fox!", "unaffable", "caf\xe9, \u4f60\u597d dog", "the the the", "",
         "zebra unaffable !", "Caf\xe9 \u4f60\u597d", "the zebra", "jumped over the lazy dog!"]


def _np(t):
    return np.asarray(t._data) if hasattr(t, "_data") else t.detach().cpu().numpy()


# ---- datasets ----

DATASETS = {
    "Imdb": dict(size=64),
    "Imikolov": dict(size=128),
    "Movielens": dict(size=128),
    "UCIHousing": dict(),
    "Conll05st": dict(),
    "WMT14": dict(size=64),
    "WMT16": dict(size=64, src_dict_size=500, trg_dict_size=300),
}


def _same_sample(a, b, what):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same_sample(x, y, f"{what}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_samples_bit_equal(name, mode):
    jd = getattr(jtext, name)(mode=mode, **DATASETS[name])
    pd = getattr(ptext, name)(mode=mode, **DATASETS[name])
    assert isinstance(pd, tp.io.Dataset) and len(pd) == len(jd) > 0
    for i in range(len(jd)):
        _same_sample(pd[i], jd[i], f"{name}[{i}]")


def test_dataset_dicts():
    assert ptext.Imdb(size=8).word_idx() == jtext.Imdb(size=8).word_idx()
    assert ptext.Conll05st(size=8).get_dict() == jtext.Conll05st(size=8).get_dict()
    for rev in (False, True):
        assert (ptext.WMT16(size=8).get_dict(reverse=rev)
                == jtext.WMT16(size=8).get_dict(reverse=rev))


def test_conll05st_through_the_dataloader():
    loader = tp.io.DataLoader(ptext.Conll05st(size=40), batch_size=16, device="cpu")
    words, preds, labels = next(iter(loader))
    assert words.shape == (16, 32) and preds.shape == (16, 1) and words.dtype == torch.int64
    np.testing.assert_array_equal(labels.numpy(), words.numpy() % 67)


# ---- viterbi ----

def _viterbi_inputs(seed, bz, T, n, lengths):
    rng = np.random.RandomState(seed)
    return (rng.randn(bz, T, n).astype(np.float32), rng.randn(n, n).astype(np.float32),
            np.array(lengths, np.int64))


@pytest.mark.parametrize("use_tag", [True, False])
@pytest.mark.parametrize("seed,bz,T,n,lengths", [
    (0, 4, 5, 3, [5, 3, 1, 4]), (1, 6, 9, 7, [1, 9, 2, 7, 9, 4]), (2, 3, 4, 5, [2, 2, 1]),
    (3, 2, 1, 4, [1, 1]), (4, 8, 32, 69, [32, 1, 17, 5, 32, 9, 2, 30])])
def test_viterbi_decode_matches_jax(use_tag, seed, bz, T, n, lengths):
    pot, trans, lens = _viterbi_inputs(seed, bz, T, n, lengths)
    js, jpath = jtext.viterbi_decode(jp.to_tensor(pot), jp.to_tensor(trans),
                                     jp.to_tensor(lens), include_bos_eos_tag=use_tag)
    ps, ppath = ptext.viterbi_decode(torch.from_numpy(pot), torch.from_numpy(trans),
                                     torch.from_numpy(lens), include_bos_eos_tag=use_tag)
    assert ppath.dtype == torch.int64 and tuple(ppath.shape) == (bz, max(lengths))
    np.testing.assert_array_equal(_np(ppath), _np(jpath))
    np.testing.assert_allclose(_np(ps), _np(js), rtol=0, atol=1e-6)


def test_viterbi_decoder_layer_matches_jax():
    pot, trans, lens = _viterbi_inputs(5, 5, 6, 4, [6, 1, 3, 5, 2])
    jdec = jtext.ViterbiDecoder(jp.to_tensor(trans), include_bos_eos_tag=False)
    pdec = ptext.ViterbiDecoder(trans, include_bos_eos_tag=False)
    assert torch.is_tensor(pdec.transitions)
    js, jpath = jdec(jp.to_tensor(pot), jp.to_tensor(lens))
    ps, ppath = pdec.forward(torch.from_numpy(pot), torch.from_numpy(lens))
    np.testing.assert_array_equal(_np(ppath), _np(jpath))
    np.testing.assert_allclose(_np(ps), _np(js), rtol=0, atol=1e-6)


def test_viterbi_trims_to_the_longest_sequence():
    pot, trans, lens = _viterbi_inputs(6, 3, 10, 4, [4, 6, 2])
    _, path = ptext.viterbi_decode(torch.from_numpy(pot), torch.from_numpy(trans),
                                   torch.from_numpy(lens))
    assert tuple(path.shape) == (3, 6)
    assert (path[2, 2:] == 0).all() and (path[0, 4:] == 0).all()


# ---- tokenizer ----

@pytest.fixture(scope="module")
def toks():
    return ptext.FasterTokenizer(VOCAB), jtext.FasterTokenizer(VOCAB)


def _oracle(text, vocab, unk_id, lower=True):
    ids = []
    for w in pft.basic_tokenize(text, lower):
        ids.extend(pft.wordpiece_tokenize(w, vocab, unk_id))
    return ids


def test_the_native_library_gives_the_python_oracles_ids(toks):
    p, _ = toks
    v = {t: i for i, t in enumerate(VOCAB)}
    for t in TEXTS + EXOTIC:
        assert p._native.tokenize(t) == _oracle(t, v, p.unk_id), t


@pytest.mark.parametrize("case", ["single", "batch", "pairs", "truncate", "pad", "exotic"])
def test_tokenizer_matches_jax(toks, case):
    p, j = toks
    kw = {"single": dict(text=TEXTS[0]),
          "batch": dict(text=TEXTS),
          "pairs": dict(text=["the quick fox", "a dog"], text_pair=["over a lazy dog", "the fox"]),
          "truncate": dict(text=["the quick brown fox jumped", "a"],
                           text_pair=["over the lazy dog !", "unaffable unaffable"],
                           max_seq_len=8),
          "pad": dict(text=TEXTS[:4], max_seq_len=12, pad_to_max_seq_len=True),
          "exotic": dict(text=EXOTIC)}[case]
    pids, ptt = p(**kw)
    jids, jtt = j(**kw)
    assert pids.dtype == ptt.dtype == torch.int64 and pids.device.type == "cpu"
    np.testing.assert_array_equal(pids.numpy(), _np(jids))
    np.testing.assert_array_equal(ptt.numpy(), _np(jtt))


def test_tokenizer_cased_and_dict_vocabs_match_jax(tmp_path):
    v = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 7, "[SEP]": 9, "hello": 7007, "Hello": 12,
         "##s": 3}
    for lower in (True, False):
        p, j = ptext.FasterTokenizer(v, do_lower_case=lower), \
            jtext.FasterTokenizer(v, do_lower_case=lower)
        for text in ("hello zzz", "Hellos HELLO", "hellos"):
            np.testing.assert_array_equal(p(text)[0].numpy(), _np(j(text)[0]))
    assert ptext.FasterTokenizer(v)("hello zzz")[0].tolist() == [[7, 7007, 100, 9]]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    p, j = ptext.FasterTokenizer(str(path)), jtext.FasterTokenizer(str(path))
    np.testing.assert_array_equal(p(TEXTS)[0].numpy(), _np(j(TEXTS)[0]))


def test_tokenizer_refuses_too_short_a_max_seq_len(toks):
    with pytest.raises(ValueError, match="cannot hold"):
        toks[0]("a", text_pair="dog", max_seq_len=2)


def test_no_python_fallback(monkeypatch):
    def broken(name):
        raise RuntimeError(f"g++ not found: the native {name} library ...")

    monkeypatch.setattr(pft, "load_library", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        ptext.FasterTokenizer(VOCAB)


def test_tokenizer_to_ernie_matches_jax():
    """The reference's faster_tokenizer -> ERNIE pipeline at ernie_tiny
    widths: the same ids into the JAX model and its weights carried over."""
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group
    from paddle_tpu.models.ernie import ErnieForPretraining as JaxErnie
    from paddle_tpu.models.ernie import ernie_tiny as jax_ernie_tiny
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_tiny, load_jax_state
    from torch_numpy_init import numpy_init

    vocab = VOCAB + [f"w{i}" for i in range(1024 - len(VOCAB))]
    texts = ["the quick brown fox jumped over the lazy dog!", "你 好 café w17 w900 unaffable",
             "W3 w4, w5 ! zebra"]
    pids, ptt = ptext.FasterTokenizer(vocab)(texts, text_pair=["a dog", "w1 w2", "the"],
                                             max_seq_len=16, pad_to_max_seq_len=True)
    jids, jtt = jtext.FasterTokenizer(vocab)(texts, text_pair=["a dog", "w1 w2", "the"],
                                             max_seq_len=16, pad_to_max_seq_len=True)
    np.testing.assert_array_equal(pids.numpy(), _np(jids))
    set_hybrid_communicate_group(None)
    with numpy_init(0):
        jm = JaxErnie(jax_ernie_tiny())
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_state(ErnieForPretraining(ernie_tiny(), device="cpu"), state)
    jm.eval()
    pm.eval()
    jh, jpool = jm.ernie(jids, token_type_ids=jtt)
    with torch.no_grad():
        ph, ppool = pm.ernie(pids, ptt)
    for got, want, what in ((ph, jh, "hidden"), (ppool, jpool, "pooled")):
        want = _np(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())),
                                   err_msg=what)
