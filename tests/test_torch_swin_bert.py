"""Swin and BERT, GroundingDINO's towers, against the JAX package on the CPU.

Seeded JAX-layout parameters (models/convert.py:random_jax_params) go
through both packages (the port's side by swin_from_jax / bert_from_jax);
the same seeded numpy inputs; fp32; outputs within ATOL. Swin runs
SWIN_TEST on a square 64² input, on a non-square 96x64 one, whose stage
grids (24x16, 12x8, 6x4, the last padded to the window) engage shifted
windows (the case of tests/test_swin.py:40), and on 88x72, whose
grids 22x18, 11x9 and 6x5 have odd sides for the patch merging to pad and
sides off the window for the blocks to pad and crop. BERT runs BERT_TEST
with GroundingDINO's pairwise sub-sentence mask and explicit position ids,
and with a padding mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freepose_tpu.models import bert as jbert
from freepose_tpu.models import swin as jswin
from freepose_tpu.models.grounding_dino import text_token_masks as jax_text_token_masks
from freepose_tpu_torch.models.bert import BERT_TEST, Bert
from freepose_tpu_torch.models.convert import bert_from_jax, random_jax_params, swin_from_jax
from freepose_tpu_torch.models.swin import SWIN_TEST, SwinBackbone, _rel_pos_index, _shift_attn_mask

ATOL = 1e-4


def _japply(module, tree, *args):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(tree, *(jnp.asarray(a) for a in args))


def test_window_tables_match_jax():
    for window in (4, 7, 12):
        np.testing.assert_array_equal(_rel_pos_index(window), jswin._rel_pos_index(window))
    for hp, wp, window, shift in ((8, 8, 4, 2), (24, 16, 4, 2), (204, 204, 12, 6), (36, 36, 12, 6)):
        np.testing.assert_array_equal(_shift_attn_mask(hp, wp, window, shift),
                                      jswin._shift_attn_mask(hp, wp, window, shift))


@pytest.mark.parametrize("hw", [(64, 64), (96, 64), (88, 72)], ids=["square", "nonsquare_shift", "odd_merge"])
def test_swin_matches_jax(hw):
    tree = random_jax_params(SwinBackbone(SWIN_TEST), seed=0)
    img = np.random.default_rng(1).normal(size=(2, 3, *hw)).astype(np.float32)
    ref = _japply(jswin.SwinBackbone(jswin.SWIN_TEST), tree, img)
    model = SwinBackbone(SWIN_TEST).eval()
    model.load_state_dict(swin_from_jax(tree))
    with torch.no_grad():
        ours = model(torch.as_tensor(img))
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


@pytest.mark.parametrize("mask_kind", ["pairwise", "padding"])
def test_bert_with_mask_and_position_ids_matches_jax(mask_kind):
    """GroundingDINO's [B, T, T] sub-sentence mask with its position ids,
    and a [B, T] padding mask with default positions."""
    tree = random_jax_params(Bert(BERT_TEST), seed=2)
    ids = np.array([[1, 5, 6, 12, 7, 8, 12, 2], [1, 9, 12, 3, 4, 2, 0, 0]])
    if mask_kind == "pairwise":
        special = np.select([ids == 12, ids == 1, ids == 2], [1012, 101, 102], ids)
        mask, pos = jax_text_token_masks(special)
        assert not mask.all() and pos.max() > 0  # the mask splits sub-sentences
    else:
        mask, pos = (ids > 0) | (np.arange(8) < 2), None
    mask = mask.astype(np.int32)

    def jax_fwd(p, i, m, q):
        return jbert.Bert(jbert.BERT_TEST).apply({"params": p}, i, attention_mask=m, position_ids=q)

    ref = jax.jit(jax_fwd)(tree, jnp.asarray(ids), jnp.asarray(mask), None if pos is None else jnp.asarray(pos))
    model = Bert(BERT_TEST).eval()
    model.load_state_dict(bert_from_jax(tree))
    with torch.no_grad():
        ours = model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                     position_ids=None if pos is None else torch.as_tensor(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
