"""The CE template-range modes of the port's flagship (CTR_POINT, CTR_REC,
ALL and GT_BOX) against the JAX model on the same weights and inputs, at
f32.

Geometry of tests/test_torch_port_model.py with a 128 template, so that the
template grid is 8 x 8 (the recipes' grid) and CTR_REC pools a 2 x 2
rectangle of each template copy, at depth 2 with CE at both blocks and one
fusion layer (the JAX side's tracing is most of the time). The search tokens each CE block keeps are
held equal as sets to the JAX model's (it keeps them in descending score
order; scores that differ by the two sides' rounding may swap two kept
tokens' places, never the set); the boxes agree within atol 2e-5, as in
test_torch_port_model.py (both sides f32, JAX at "highest" matmul
precision, ~2e-6 apart through the layers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.utils.convert import from_jax_variables

from tests.test_torch_port_model import GEOM, _randomise
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

T_SZ, S_SZ = 128, 176
CE_GEOM = dict(GEOM, template_size=T_SZ, depth=2, ce_loc=(0, 1), fusion_layers=1)
ATOL = 2e-5
BOXES = np.array([[0.25, 0.3, 0.4, 0.35], [0.1, 0.5, 0.3, 0.25]], np.float32)


@pytest.fixture(scope="module")
def weights():
    """One draw of the JAX variables (no parameter depends on the mode)."""
    geom = CE_GEOM
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(drop_path_rate=0.0, **geom))
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    return _randomise(jax.jit(jmodel.init)(jax.random.PRNGKey(21), tz, tz, sz), 21)


def _build(mode, variables):
    geom = dict(CE_GEOM, ce_template_range=mode)
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(drop_path_rate=0.0, **geom))
    pmodel = port_as.MixFormerRGBT(port_as.RGBTSpec(**geom)).eval()
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, pmodel


def _inputs(seed):
    """Two streams: (2B, ...) stacks, [:B] RGB and [B:] TIR, B = 2."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, T_SZ, T_SZ, 3)).astype(np.float32),
            rng.standard_normal((4, T_SZ, T_SZ, 3)).astype(np.float32),
            rng.standard_normal((4, S_SZ, S_SZ, 3)).astype(np.float32))


SELECT = {jax_as: jax_as._ce_select, port_as: port_as._ce_select}


def _recording(module, kept):
    """The module's _ce_select, recording the kept positions (gidx_new)."""
    select = SELECT[module]

    def wrapped(*args):
        out = select(*args)
        kept.append(out[1])
        return out
    return wrapped


def _jax_run(jmodel, variables, x, boxes, monkeypatch):
    """(full forward's boxes, its kept positions, cached path's boxes, its
    kept positions), both paths in one jit."""
    def run(v, t, ot, s, b):
        kept_full, kept_cached = [], []
        monkeypatch.setattr(jax_as, "_ce_select", _recording(jax_as, kept_full))
        full = jmodel.apply(v, t, ot, s, None, ce_gt_boxes=b)["pred_boxes"]
        monkeypatch.setattr(jax_as, "_ce_select", _recording(jax_as, kept_cached))
        cache = jmodel.apply(v, t, ot, method=type(jmodel).set_online)
        cached = jmodel.apply(v, cache, s, method=type(jmodel).forward_track)["pred_boxes"]
        return full, kept_full, cached, kept_cached
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(variables, *x, boxes))


def _port_run(pmodel, x, boxes, monkeypatch):
    t, ot, s = (torch.from_numpy(a) for a in x)
    kept_full, kept_cached = [], []
    with torch.no_grad():
        monkeypatch.setattr(port_as, "_ce_select", _recording(port_as, kept_full))
        full = pmodel(t, ot, s, ce_gt_boxes=None if boxes is None else torch.from_numpy(boxes))
        monkeypatch.setattr(port_as, "_ce_select", _recording(port_as, kept_cached))
        cached = pmodel.forward_track(pmodel.set_online(t, ot), s)
    return (full["pred_boxes"].numpy(), [k.numpy() for k in kept_full],
            cached["pred_boxes"].numpy(), [k.numpy() for k in kept_cached])


@pytest.mark.parametrize("mode", ["CTR_REC", "ALL", "GT_BOX"])
def test_mode_matches_jax(weights, mode, monkeypatch):
    """The full forward (GT_BOX with boxes) and the cached tracking path
    (GT_BOX there has no boxes and pools every row, in both packages)."""
    jmodel, pmodel = _build(mode, weights)
    x = _inputs(22)
    b = BOXES if mode == "GT_BOX" else None
    want = _jax_run(jmodel, weights, x, b, monkeypatch)
    got = _port_run(pmodel, x, b, monkeypatch)
    for g_box, w_box in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g_box, w_box, atol=ATOL, rtol=0)
    for g_kept, w_kept in ((got[1], want[1]), (got[3], want[3])):
        assert len(g_kept) == len(w_kept) == 4      # 2 CE blocks x 2 modalities
        for g, w in zip(g_kept, w_kept):
            np.testing.assert_array_equal(np.sort(g, axis=1), np.sort(w, axis=1))


def test_modes_rank_differently(weights):
    """Each mode pools other rows, so the kept tokens differ between modes on
    one model; GT_BOX without boxes is ALL."""
    _, pmodel = _build("CTR_POINT", weights)
    x = [torch.from_numpy(a) for a in _inputs(24)]
    kept = {}
    for mode in ("CTR_POINT", "CTR_REC", "ALL", "GT_BOX"):
        pmodel.backbone.ce_template_range = mode
        t, ot, s = pmodel.backbone(*x, ce_gt_boxes=torch.from_numpy(BOXES))
        kept[mode] = (s != 0).any(-1).numpy()
    assert len({v.tobytes() for v in kept.values()}) == 4
    pmodel.backbone.ce_template_range = "GT_BOX"
    no_boxes = pmodel.backbone(*x)[2]
    pmodel.backbone.ce_template_range = "ALL"
    assert torch.equal(no_boxes, pmodel.backbone(*x)[2])


def test_rows_of_the_static_modes():
    """CTR_REC pools rows 3:5 x 3:5 of each 8 x 8 copy, CTR_POINT cell 3,3,
    in the JAX package's order."""
    vit = port_as.AsymSharedViT(img_size_s=S_SZ, img_size_t=T_SZ, embed_dim=32, depth=1,
                                num_heads=2, ce_template_range="CTR_REC")
    q = torch.arange(2 * 2 * 4 * 64 * 3, dtype=torch.float32).reshape(2, 2, 256, 3)
    k = torch.zeros(2, 2, 5, 3)
    rows = [g * 64 + r * 8 + c for g in range(4) for r in (3, 4) for c in (3, 4)]
    a = port_as._t2s_attention(q, k, 1.0, vit._ce_rows(True))
    assert a.shape == (2, 2, 16, 5) and vit._ce_rows(False) is None
    got = q.reshape(2, 2, 4, 8, 8, 3)[:, :, :, 3:5, 3:5].reshape(2, 2, 16, 3)
    assert torch.equal(got, q[:, :, rows])
    for F, span in ((8, (3, 5)), (12, (5, 7)), (7, (3, 4)), (11, (5, 6))):
        assert port_as._ctr_rec_span(F) == jax_as._ctr_rec_span(F) == span
    with pytest.raises(ValueError, match="CE_TEMPLATE_RANGE"):
        port_as.AsymSharedViT(ce_template_range="CENTRE")


@pytest.mark.parametrize("grid", [8, 7])
def test_box_row_weights_match_jax(grid):
    """GT_BOX's rasterised and downsampled box, on boxes whose edges fall on
    template pixels exactly (the floor and the "len - 1" truncation), on
    fractional ones, on a box past the crop and on an empty one."""
    size = 16 * grid
    px = np.array([[32, 40, 48, 24], [0, 0, size, size], [8, 9, 1, 1], [-10, 100, 200, 30],
                   [33.5, 17.25, 40.75, 60.5], [64, 64, 0, 0]], np.float32)
    boxes = px / size
    want = np.asarray(jax_as.ce_box_row_weights(jnp.asarray(boxes), size, grid))
    got = port_as.ce_box_row_weights(torch.from_numpy(boxes), size, grid).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, grid * grid) and got[0].any() and not got[5].any()
