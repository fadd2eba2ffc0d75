"""The port's WordPiece tokenizer (a copy of the JAX package's) against the
JAX package's, on a vocabulary the test writes: the same ids, exactly."""
import numpy as np
import pytest

from freepose_tpu.models.wordpiece import WordPieceTokenizer as JaxTokenizer
from freepose_tpu_torch.models.wordpiece import WordPieceTokenizer

TEXTS = ["objects.", "Objects. unknowable", "a photo of cats!", "of of of", "zzz, cats?", "  ", "Ünknown café."]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    tokens = ["[PAD]"] * 100 + ["[UNK]", "[CLS]", "[SEP]"] + [
        "objects", ".", "a", "photo", "of", "cat", "##s", "un", "##know", "##able", ",", "?", "!", "caf", "##e",
    ]
    path = tmp_path_factory.mktemp("wordpiece") / "vocab.txt"
    path.write_text("\n".join(tokens))
    return path


@pytest.mark.parametrize("text", TEXTS)
def test_encode_matches_jax(vocab, text):
    assert WordPieceTokenizer(vocab).encode(text) == JaxTokenizer(vocab).encode(text)


def test_batch_padding_matches_jax(vocab):
    ids, mask = WordPieceTokenizer(vocab)(TEXTS, max_length=5)
    ref_ids, ref_mask = JaxTokenizer(vocab)(TEXTS, max_length=5)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)
    assert ids.shape == (len(TEXTS), 5) and ids.dtype == np.int64
