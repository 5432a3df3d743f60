"""paddle.text of the port (counterpart of paddle_tpu/text/): the text
datasets from their synthetic sets (``datasets.py``), Viterbi decoding
(``viterbi.py``) and the FasterTokenizer over the native ``tokenizer.cc``
(``faster_tokenizer.py``)."""
from .datasets import WMT14, WMT16, Conll05st, Imdb, Imikolov, Movielens, UCIHousing
from .faster_tokenizer import FasterTokenizer, wordpiece_tokenize
from .viterbi import ViterbiDecoder, viterbi_decode

__all__ = ["Imdb", "Imikolov", "Movielens", "UCIHousing", "Conll05st", "WMT14", "WMT16",
           "FasterTokenizer", "wordpiece_tokenize", "ViterbiDecoder", "viterbi_decode"]
