"""The port's visualisation (multi_modal_tracking_torch.eval.visualize and the
models' diagnostic outputs) against the JAX package's, which draws with cv2.

  * rectangles and label text against cv2 itself, byte for byte;
  * `draw_boxes`, `feature_panel`, `attention_panel` (with and without the
    crop) and the runner's `_vis_frame` against the JAX functions on the
    same numpy inputs, byte for byte. `draw_boxes` is compared outside each
    label's rectangle and, separately, inside it, where the port draws the
    glyph table made with cv2 (`eval/_glyphs.py`); inside the labels the
    bytes are equal too on these inputs (the test asserts it and reports the
    count of differing bytes in its message if they are not);
  * `return_attn_maps` (the flagship backbone) and `return_features` (the
    flagship and an RGB-T ViT model) against the JAX models at f32 (JAX at
    "highest" matmul precision): the maps (values in [0, 1]) within 1e-5,
    the per-modality search features within 1e-5 of their largest
    magnitude (measured up to 1.5e-5 absolute on features of magnitude
    ~12, 1.3e-6 of it); the fused features within 1e-4, since the fusion's deformable
    sampling sums its taps in another order than JAX's dense einsums
    (measured 4.4e-5 to 5.8e-5 on three input draws, 1e-5 to 1.7e-5 of the
    tensor's largest magnitude; the boxes agree within 2e-5,
    tests/test_torch_port_model.py). The maps and the panels are compared
    separately, since a 1e-6 difference in a map can flip a uint8 after the
    min-max normalisation;
  * the dumps' PNGs decode to the JAX arrays that cv2.imwrite is given
    (JAX's panels of JAX's maps equal the port's panels of the same maps,
    and the port's PNGs decode to the port's panels of its maps).

`python tests/test_torch_port_visualize.py --write-glyphs` regenerates the
glyph table with cv2 (PYTHONPATH = the repository).
"""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cv2
import jax
import jax.numpy as jnp

from multi_modal_tracking_tpu.eval import running as jax_running
from multi_modal_tracking_tpu.eval import visualize as jax_vis
from multi_modal_tracking_tpu.models import vit_rgbt as jax_vr

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.eval import running, visualize
from multi_modal_tracking_torch.eval._glyphs import GLYPHS
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models import vit_rgbt as port_vr
from multi_modal_tracking_torch.tracking import tracker as port_tracker
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ, _pair, _randomise
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FONT = cv2.FONT_HERSHEY_SIMPLEX
ORG = (40, 60)
ATOL = 1e-5
FUSED_ATOL = 1e-4


def _feature_atol(k: str, want: np.ndarray) -> float:
    """The features' tolerance of the module docstring."""
    return FUSED_ATOL if k == "search_fused" else ATOL * max(1.0, float(np.abs(want).max()))


@pytest.fixture(scope="module", autouse=True)
def _jax_highest():
    """f32 matmuls in JAX."""
    with jax.default_matmul_precision("highest"):
        yield


# ------------------------------------------------------------- glyph table
def _render(text: str) -> np.ndarray:
    img = np.zeros((120, 900), np.uint8)
    cv2.putText(img, text, ORG, FONT, 0.5, 255, 1)
    return img


def _advance(ch: str, n: int = 16) -> int:
    """The pen's whole-pixel advance after `ch`: where a marker lands after
    n copies of it, over n (it lands on the same pixels as alone)."""
    mark = _render("|")
    after = _render(ch * n + "|").astype(np.int64) - _render(ch * n).astype(np.int64)
    shift = int(np.nonzero(after.any(0))[0][0] - np.nonzero(mark.any(0))[0][0])
    assert np.array_equal(np.roll(mark, shift, axis=1), after) and shift % n == 0, ch
    return shift // n


def glyph_table() -> dict:
    """code -> (advance, top, left, rows, cols, coverage hex) of each
    printable ASCII character drawn alone at an integer pen position."""
    table = {}
    for code in range(32, 127):
        a = _render(chr(code))
        ys, xs = np.nonzero(a)
        if len(ys):
            crop = a[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
            table[code] = (_advance(chr(code)), int(ys.min()) - ORG[1], int(xs.min()) - ORG[0],
                           crop.shape[0], crop.shape[1], crop.tobytes().hex())
        else:
            table[code] = (_advance(chr(code)), 0, 0, 0, 0, "")
    return table


def write_glyphs(path: str) -> None:
    lines = ['"""Coverage of each printable ASCII character of cv2.putText',
             "(FONT_HERSHEY_SIMPLEX, scale 0.5, thickness 1) drawn alone at an integer",
             "pen position: code -> (advance px, top row and left column relative to",
             "the pen, rows, columns, coverage bytes 0..255 in hex). Generated with",
             f"cv2 {cv2.__version__} by `python tests/test_torch_port_visualize.py",
             '--write-glyphs`; read by eval/visualize.py put_text."""', "", "GLYPHS = {"]
    for code, (adv, top, left, h, w, hexs) in glyph_table().items():
        chunks = [hexs[i:i + 72] for i in range(0, len(hexs), 72)] or [""]
        body = "\n         ".join(f'"{c}"' for c in chunks)
        lines.append(f"    {code}: ({adv}, {top}, {left}, {h}, {w},\n         {body}),")
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_glyph_table_is_cv2s():
    assert GLYPHS == glyph_table()


# ------------------------------------------------------ drawing against cv2
def test_draw_rect_matches_cv2():
    rng = np.random.default_rng(0)
    for _ in range(300):
        p1, p2 = (tuple(int(v) for v in rng.integers(-12, 62, 2)) for _ in range(2))
        for t in (1, 2):
            want = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
            got = want.copy()
            cv2.rectangle(want, p1, p2, (0, 255, 255), t)
            visualize.draw_rect(got, p1, p2, (0, 255, 255), t)
            np.testing.assert_array_equal(got, want, err_msg=f"{p1} {p2} {t}")


def test_put_text_matches_cv2():
    """Random printable strings at random pens (labels cut by every border
    too) on random backgrounds and colours: equal bytes."""
    rng = np.random.default_rng(1)
    chars = [chr(c) for c in range(32, 127)]
    for _ in range(150):
        text = "".join(rng.choice(chars, int(rng.integers(1, 14))))
        org = (int(rng.integers(-30, 90)), int(rng.integers(-5, 60)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = rng.integers(0, 256, (48, 96, 3), dtype=np.uint8)
        got = want.copy()
        cv2.putText(want, text, org, FONT, 0.5, color, 1)
        visualize.put_text(got, text, org, color)
        np.testing.assert_array_equal(got, want, err_msg=repr((text, org)))


# --------------------------------------------------- against the JAX package
def _frame(seed, H=120, W=160):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)


def label_extent(name: str, org):
    """(x0, y0, x1, y1), inclusive: the pixels the glyph table lets
    `put_text` touch for `name` at `org` (a label's rectangle)."""
    x, y = org
    x0 = y0 = 10 ** 9
    x1 = y1 = -10 ** 9
    for ch in name:
        adv, dy, dx, h, w, _ = GLYPHS[ord(ch)]
        if h:
            x0, y0 = min(x0, x + dx), min(y0, y + dy)
            x1, y1 = max(x1, x + dx + w - 1), max(y1, y + dy + h - 1)
        x += adv
    return x0, y0, x1, y1


def test_draw_boxes_matches_jax():
    """Outside the labels' rectangles equal bytes; inside them the glyph
    table's pixels, measured: the count of differing bytes there is 0."""
    rng = np.random.default_rng(2)
    for seed in range(12):
        frame = _frame(seed)
        boxes = {"GT": rng.uniform(-10, 140, 4), "ours": rng.uniform(0, 100, 4),
                 "other tracker": rng.uniform(5, 80, 4), "nan": np.full(4, np.nan),
                 "none": None}
        want, got = jax_vis.draw_boxes(frame, boxes), visualize.draw_boxes(frame, boxes)
        outside = np.ones(frame.shape[:2], bool)
        for name, b in boxes.items():
            if b is None or not np.all(np.isfinite(b)):
                continue
            x, y = int(round(float(b[0]))), int(round(float(b[1])))
            x0, y0, x1, y1 = label_extent(name, (x, max(12, y - 4)))
            outside[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = False
        np.testing.assert_array_equal(got[outside], want[outside])
        inside = int((got[~outside] != want[~outside]).sum())
        assert inside == 0, f"{inside} differing bytes inside the labels"


@pytest.mark.parametrize("size", [144, 100])
def test_feature_panel_matches_jax(size):
    rng = np.random.default_rng(size)
    for shape in ((18, 18, 64), (11, 11, 8), (7, 9, 3)):
        feat = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(visualize.feature_panel(feat, size),
                                      jax_vis.feature_panel(feat, size))
    flat = np.ones((5, 5, 4), np.float32)
    np.testing.assert_array_equal(visualize.feature_panel(flat), jax_vis.feature_panel(flat))


@pytest.mark.parametrize("crop", [False, True], ids=["heat", "over_crop"])
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_attention_panel_matches_jax(crop, alpha):
    rng = np.random.default_rng(7)
    for gs, size in ((18, 144), (11, 100), (16, 64)):
        grid = rng.random((gs, gs)).astype(np.float32)
        grid[rng.random((gs, gs)) < 0.3] = 0.0              # pruned positions
        fc = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8) if crop else None
        np.testing.assert_array_equal(
            visualize.attention_panel(grid, fc, size, alpha),
            jax_vis.attention_panel(grid, fc, size, alpha))


def test_vis_frame_matches_jax():
    rng = np.random.default_rng(3)
    for seed in range(20):
        frame = _frame(seed)
        pair = [frame, _frame(seed + 100)]
        pred, prev = rng.uniform(-20, 150, 4), rng.uniform(0, 120, 4)
        for f in (frame, np.stack(pair)):
            np.testing.assert_array_equal(running._vis_frame(f, pred, prev, 4.5),
                                          jax_running._vis_frame(f.copy(), pred, prev, 4.5))


def test_png_decodes_to_the_array(tmp_path):
    """encode_png of a BGR panel: the port's decoder reads the RGB pixels,
    cv2.imread the BGR array (what cv2.imwrite of it would store)."""
    bgr = _frame(9, 33, 47)
    path = visualize.write_png(str(tmp_path / "p.png"), bgr)
    np.testing.assert_array_equal(native.imread(path), bgr[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(path), bgr)


# ------------------------------------------------ the models' diagnostics
@pytest.fixture(scope="module")
def ce_pair():
    return _pair(GEOM, 0)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((2, T_SZ, T_SZ, 3), (2, T_SZ, T_SZ, 3), (2, S_SZ, S_SZ, 3)))


@pytest.mark.parametrize("keep", [0.7, 1.0])
def test_attention_maps_match_jax(ce_pair, keep):
    jm, variables, pm = ce_pair
    t, ot, s = _inputs(11)
    fn = jax.jit(lambda v, a, b, c: jm.apply(
        v, a, b, c, keep, method=lambda m, *x: m.backbone(*x, True, True,
                                                           return_attn_maps=True)))
    want = fn(variables, t, ot, s)
    with torch.no_grad():
        got = pm.backbone(*(torch.from_numpy(x) for x in (t, ot, s)), keep, True,
                          return_attn_maps=True)
    assert sorted(got[-1]) == sorted(want[-1]) == list(GEOM["ce_loc"])
    for bi in want[-1]:
        w = np.asarray(want[-1][bi])
        assert got[-1][bi].shape == w.shape == (1, 2, S_SZ // 16, S_SZ // 16)
        np.testing.assert_allclose(got[-1][bi].numpy(), w, atol=ATOL, rtol=0)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_flagship_features_match_jax(ce_pair):
    jm, variables, pm = ce_pair
    t, ot, s = _inputs(12)
    want = jax.jit(lambda v, a, b, c: jm.apply(v, a, b, c, None, return_features=True))(
        variables, t, ot, s)
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in (t, ot, s)), None, return_features=True)
    for k in ("search_v", "search_i", "search_fused", "pred_boxes"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, err_msg=k,
                                   atol=_feature_atol(k, w))


VIT_RGBT = dict(search_size=64, template_size=32, embed_dim=64, depth=2, num_heads=4,
                head_type="CORNER_UP", head_dim=64,
                fusion_class="Attention_Fusion_Bimodal_LNSpecific", fusion_layers=1)


def test_vit_rgbt_features_match_jax():
    from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
    jm = jax_vr.MixFormerViTRGBT(spec=jax_vr.VitRGBTSpec(
        base=jax_as.RGBTSpec(**VIT_RGBT, drop_path_rate=0.0), variant="shared"))
    rng = np.random.default_rng(5)
    t = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    s = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    variables = _randomise(jax.jit(jm.init)(jax.random.PRNGKey(0), t, t, s), 5)
    pm = port_vr.MixFormerViTRGBT(port_as.RGBTSpec(**VIT_RGBT, drop_path_rate=0.0),
                                  "shared").eval()
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    want = jax.jit(lambda v, a, c: jm.apply(v, a, a, c, return_features=True))(variables, t, s)
    with torch.no_grad():
        got = pm(torch.from_numpy(t), torch.from_numpy(t), torch.from_numpy(s),
                 return_features=True)
    for k in ("search_v", "search_i", "search_fused", "pred_boxes"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, err_msg=k,
                                   atol=_feature_atol(k, w))


# -------------------------------------------------------------- the dumps
def _sequence_frames(seed=4, H=240, W=320):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    i = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    return [[v[k], i[k]] for k in range(2)], {"init_bbox": [120.0, 90.0, 48.0, 40.0]}


def _port_tracker(pm, cached=True):
    cls = port_tracker.RGBTCachedTracker if cached else port_tracker.RGBTTracker
    return cls(pm, template_factor=2.0, template_size=T_SZ, search_factor=4.5,
               search_size=S_SZ, ce_keep_rate=0.7, device="cpu")


def _jax_stub(tr, jm, variables):
    """What the JAX dumps read of a JAX tracker, at the port tracker's
    templates and state."""
    t = tr._template.numpy()
    st = SimpleNamespace(template_v=jnp.asarray(t[:1]), template_i=jnp.asarray(t[1:]),
                         state=jnp.asarray(tr._state.numpy()))
    return SimpleNamespace(_state=st, model=jm, variables=variables, ce_keep_rate=0.7,
                           search_factor=4.5, search_size=S_SZ, initialize=lambda *a: None)


class _Imwrite:
    """cv2 for the JAX dumps with imwrite capturing the arrays."""

    def __init__(self):
        self.arrays = {}

    def __getattr__(self, name):
        return getattr(cv2, name)

    def imwrite(self, path, arr):
        self.arrays[os.path.basename(path)] = np.array(arr)
        return True


def test_dump_attention_maps_decode_to_jax_arrays(ce_pair, tmp_path, monkeypatch):
    jm, variables, pm = ce_pair
    frames, info = _sequence_frames()
    tr = _port_tracker(pm)
    tr.initialize(frames[0], info)
    paths = visualize.dump_attention_maps(tr, frames[1], str(tmp_path), frame_id=1)
    maps = visualize.attention_maps(tr, frames[1])
    fake = _Imwrite()
    monkeypatch.setattr(jax_vis, "_cv2", lambda: fake)
    stub = _jax_stub(tr, jm, variables)
    jax_vis.dump_attention_maps(stub, frames[1], str(tmp_path / "jax"), frame_id=1)
    t_vi = jnp.concatenate([stub._state.template_v, stub._state.template_i])
    jmaps = jm.apply(variables, t_vi, t_vi, jax_vis._search_crop(stub, frames[1]), 0.7,
                     method=lambda m, *x: m.backbone(*x, True, True, return_attn_maps=True))[-1]
    assert [os.path.basename(p) for p in paths] == [f"attn_block{bi:02d}_0001.png"
                                                    for bi in GEOM["ce_loc"]]
    assert sorted(fake.arrays) == [os.path.basename(p)[:-3] + "jpg" for p in paths]
    for p, bi in zip(paths, GEOM["ce_loc"]):
        np.testing.assert_allclose(maps[bi], np.asarray(jmaps[bi]), atol=ATOL, rtol=0)
        jax_row = fake.arrays[f"attn_block{bi:02d}_0001.jpg"]
        np.testing.assert_array_equal(np.concatenate(
            [visualize.attention_panel(np.asarray(jmaps[bi])[0, m]) for m in (0, 1)], axis=1),
            jax_row)
        np.testing.assert_array_equal(native.imread(p)[..., ::-1], np.concatenate(
            [visualize.attention_panel(maps[bi][0, m]) for m in (0, 1)], axis=1))


def test_dump_search_features_decode_to_jax_arrays(ce_pair, tmp_path, monkeypatch):
    jm, variables, pm = ce_pair
    frames, info = _sequence_frames(5)
    tr = _port_tracker(pm, cached=False)
    paths = visualize.dump_search_features({"flagship": tr}, frames[1], info,
                                           str(tmp_path), frame_id=3)
    feats = visualize.search_features(tr, frames[1], info)
    fake = _Imwrite()
    monkeypatch.setattr(jax_vis, "_cv2", lambda: fake)
    stub = _jax_stub(tr, jm, variables)
    jax_vis.dump_search_features({"flagship": stub}, frames[1], info, str(tmp_path / "jax"),
                                 frame_id=3)
    t_vi = jnp.concatenate([stub._state.template_v, stub._state.template_i])
    jout = jm.apply(variables, t_vi, t_vi, jax_vis._search_crop(stub, frames[1]), None,
                    return_features=True)
    keys = ("search_v", "search_i", "search_fused")
    assert [os.path.basename(p) for p in paths] == ["flagship_0003.png"]
    for k in keys:
        w = np.asarray(jout[k][0])
        np.testing.assert_allclose(feats[k], w, rtol=0, err_msg=k, atol=_feature_atol(k, w))
    np.testing.assert_array_equal(np.concatenate(
        [visualize.feature_panel(np.asarray(jout[k][0])) for k in keys], axis=1),
        fake.arrays["flagship_0003.jpg"])
    np.testing.assert_array_equal(native.imread(paths[0])[..., ::-1], np.concatenate(
        [visualize.feature_panel(feats[k]) for k in keys], axis=1))


def test_videos_need_cv2(tmp_path, monkeypatch):
    """write_video and render_result_video write an mp4 where cv2 imports,
    and raise ImportError naming cv2 where it does not."""
    from multi_modal_tracking_torch.eval import datasets
    seq = datasets.get_dataset("synthetic_rgbt", n_sequences=1, n_frames=4)[0]
    res = {"mine": seq.ground_truth_rect[:, 0] + 2.0}
    out = visualize.render_result_video(seq, res, str(tmp_path / "v.mp4"), modality=1)
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 4
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        visualize.render_result_video(seq, res, str(tmp_path / "w.mp4"))
    with pytest.raises(ImportError, match="cv2"):
        visualize.write_video(str(tmp_path / "x.mp4"), [np.zeros((8, 8, 3), np.uint8)])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-glyphs"]:
        raise SystemExit("usage: python tests/test_torch_port_visualize.py --write-glyphs")
    write_glyphs(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "multi_modal_tracking_torch", "eval", "_glyphs.py"))
