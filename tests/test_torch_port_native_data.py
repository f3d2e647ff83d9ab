"""The port's C++ host data library (`multi_modal_tracking_torch/native`,
`csrc/host/data.cpp`, built here with g++) against the port's numpy
functions, which it replaces on the Trainer's path, and the JAX package's
cv2 ones. Every comparison is bit for bit (np.array_equal on uint8 crops,
bool masks and float32 images):

  * crops: `native.sample_target` on the frame before the joint
    augmentation, with its grey and mirror flags, against the port's and
    the JAX package's `sample_target` on the augmented frame: random boxes,
    partly outside the frame, even and odd frame sizes, factors 2.0 and
    4.5, outputs 128 and 288; the crop, the resize factor, the mask and the
    mask's validity; a window with no frame pixel raises ValueError (cv2
    gives an all-padding mask, an invalid sample either way);
  * jitter: `native.jitter_jet_normalise` against `tensor_and_jitter_rgbt`
    (+ `flip_norm`), port and JAX, at factors 0.8 and 1.2 and random ones,
    with pixels at 0 and 255 that meet both clip bounds;
  * `native.apply_jet` against `apply_jet_np` and cv2's COLORMAP_JET;
  * batches: the native loader on 4 threads against the plain one (every
    key equal) and the JAX loader's sampled sequences and frames;
  * build: two processes building at once leave one good library; a broken
    source raises with the compiler's message, and so do the processing
    and the Trainer that need it.
"""
import os
import random
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.train import builders as jax_builders
from multi_modal_tracking_tpu.train.data import processing_utils as jax_pu
from multi_modal_tracking_tpu.train.data import transforms as jax_tf

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.ops import _build
from multi_modal_tracking_torch.ops.colormap import apply_jet_np
from multi_modal_tracking_torch.train import builders
from multi_modal_tracking_torch.train.data import processing as port_pr
from multi_modal_tracking_torch.train.data import processing_utils as port_pu
from multi_modal_tracking_torch.train.data import transforms as port_tf
from tests.test_torch_port_train_data import RECIPE, _logged

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ crops
def _crop_cases(H, W, seed, n=24):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        box = np.float32([rng.uniform(-0.3 * W, 1.1 * W), rng.uniform(-0.3 * H, 1.1 * H),
                          rng.uniform(3, 0.5 * W), rng.uniform(3, 0.5 * H)])
        yield box, float(rng.choice([2.0, 4.5])), int(rng.choice([128, 288]))
    # windows with no frame pixel (left of, above, below the frame)
    yield np.float32([-3 * W, 10, 8, 8]), 2.0, 128
    yield np.float32([10, -3 * H, 8, 8]), 2.0, 288
    yield np.float32([10, H + 40, 8, 8]), 4.5, 128


@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip"])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("hw", [(240, 320), (241, 317), (96, 130)], ids=lambda s: "x".join(map(str, s)))
def test_sample_target_equals_numpy_and_cv2(hw, gray, flip):
    H, W = hw
    rng = np.random.default_rng(H * W)
    frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    state = {"gray": gray, "flip": flip}
    aug, _ = port_tf.JointAugment.apply_image_pair(frame, frame, state)
    jax_aug, _ = jax_tf.JointAugment.apply_image_pair(frame, frame, state)
    np.testing.assert_array_equal(aug, jax_aug)
    compared = raised = 0
    for box, factor, out in _crop_cases(H, W, seed=H + W + 7 * gray + 3 * flip):
        try:
            want = port_pu.sample_target(aug, box, factor, out)
        except ValueError:
            with pytest.raises(ValueError):
                native.sample_target(frame, box, factor, out, gray=gray, flip=flip)
            # cv2 pads an empty crop: all padding, which the processing
            # refuses as the port's ValueError is refused
            assert jax_pu.sample_target(jax_aug, box, factor, out)[2].all()
            raised += 1
            continue
        crop, rf, mask, valid = native.sample_target(frame, box, factor, out, gray=gray,
                                                     flip=flip)
        cv = jax_pu.sample_target(jax_aug, box, factor, out)
        for ref in (want, cv):
            np.testing.assert_array_equal(crop, ref[0])
            assert rf == ref[1]
            np.testing.assert_array_equal(mask, ref[2])
        assert crop.dtype == np.uint8 and mask.dtype == np.bool_
        assert valid == port_pr._att_mask_valid(want[2], out)
        compared += 1
    assert compared >= 18 and raised >= 3


@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip"])
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_sample_target_pair_equals_two_crops(gray, flip):
    """One call for an RGB-T pair = the RGB crop (grey if asked) and the TIR
    crop (never grey) of two calls, with one resize factor and validity."""
    rng = np.random.default_rng(5)
    v = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    i = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    for box, factor, out in _crop_cases(97, 131, seed=9, n=12):
        try:
            want_v = native.sample_target(v, box, factor, out, gray=gray, flip=flip)
        except ValueError:
            with pytest.raises(ValueError):
                native.sample_target_pair(v, i, box, factor, out, gray=gray, flip=flip)
            continue
        want_i = native.sample_target(i, box, factor, out, flip=flip)
        crop_v, crop_i, rf, valid = native.sample_target_pair(v, i, box, factor, out, gray=gray,
                                                              flip=flip)
        np.testing.assert_array_equal(crop_v, want_v[0])
        np.testing.assert_array_equal(crop_i, want_i[0])
        assert rf == want_v[1] == want_i[1] and valid == want_v[3] == want_i[3]
    with pytest.raises(ValueError, match="shapes"):
        native.sample_target_pair(v, i[:, 1:], [10, 10, 20, 20], 2.0, 128)


def test_processing_native_equals_plain_on_unequal_frames():
    """A TIR frame of another size than the RGB one takes the two-call path;
    the processed sample equals the plain processing's."""
    rng = np.random.default_rng(2)
    pair = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8),
            rng.integers(0, 256, (100, 150, 3), dtype=np.uint8)]
    anno = np.float32([[50, 40, 30, 24], [45, 35, 28, 22]])

    def run(pixels, seed):
        p = port_pr.RGBTProcessing({"template": 2.0, "search": 4.5},
                                   {"template": 64, "search": 128},
                                   {"template": 0, "search": 1.0},
                                   {"template": 0, "search": 0.25},
                                   p_gray=0.5, rng=random.Random(seed), pixels=pixels)
        return p({"template_images": [pair, pair], "template_anno": [anno, anno],
                  "search_images": [pair], "search_anno": [anno]})
    n_valid = 0
    for seed in range(12):
        a, b = run("native", seed), run("plain", seed)
        assert a["valid"] == b["valid"]
        if a["valid"]:
            n_valid += 1
            for k in a:
                if k != "valid":
                    for x, y in zip(a[k], b[k]):
                        np.testing.assert_array_equal(x, y, err_msg=k)
    assert n_valid >= 6


def test_sample_target_too_small_raises():
    frame = np.zeros((40, 50, 3), np.uint8)
    for box in ([5, 5, 0.0, 4], [5, 5, -2.0, 4], [5, 5, float("nan"), 4]):
        with pytest.raises(ValueError):
            native.sample_target(frame, box, 2.0, 128)
    with pytest.raises(ValueError, match="Too small"):
        port_pu.sample_target(frame, [5, 5, 0.0, 4], 2.0, 128)


def test_invalid_masks_agree():
    """Windows that are (nearly) all padding: the validity flag at full and
    at 1/16 resolution equals `_att_mask_valid` of the numpy mask."""
    frame = np.full((60, 80, 3), 200, np.uint8)
    seen = set()
    for x in np.linspace(-400, 60, 47):
        box = np.float32([x, 20, 12, 12])
        try:
            _, _, att = port_pu.sample_target(frame, box, 4.5, 288)
        except ValueError:
            continue
        valid = native.sample_target(frame, box, 4.5, 288)[3]
        assert valid == port_pr._att_mask_valid(att, 288), x
        seen.add(valid)
    assert seen == {False, True}


# ------------------------------------------------------------------ jitter
class _Draws:
    """A stand-in rng that hands out the brightness factors given."""

    def __init__(self, *values):
        self.values = list(values)

    def uniform(self, lo, hi):
        return self.values.pop(0)


@pytest.mark.parametrize("flip", [False, True], ids=["no_flip", "flip"])
@pytest.mark.parametrize("factors", [(0.8, 1.2), (1.2, 0.8), (1.0, 1.0), None],
                         ids=["0.8_1.2", "1.2_0.8", "1_1", "random"])
@pytest.mark.parametrize("size", [128, 288])
def test_jitter_jet_normalise_equals_numpy(size, factors, flip):
    rng = np.random.default_rng(size)
    crop_v = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    crop_i = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    crop_v[:8], crop_i[:8] = 255, 255              # clip at 1 (RGB) and 255 (TIR)
    crop_v[8:16], crop_i[8:16] = 0, 0
    bf, tir_f = factors or (float(rng.uniform(0.8, 1.2)), float(rng.uniform(0.8, 1.2)))
    box = np.float32([0.2, 0.3, 0.4, 0.1])
    got_v, got_i = native.jitter_jet_normalise(crop_v, crop_i, bf, tir_f, flip)
    assert got_v.dtype == got_i.dtype == np.float32 and got_v.shape == crop_v.shape
    for tf in (port_tf, jax_tf):
        v, i = tf.tensor_and_jitter_rgbt(crop_v, crop_i, 0.2, _Draws(bf, tir_f))
        if flip:
            (v, bv), (i, _) = tf.flip_norm(v, box), tf.flip_norm(i, box)
            np.testing.assert_array_equal(port_tf.flip_box_norm(box), bv)
        np.testing.assert_array_equal(got_v, v)
        np.testing.assert_array_equal(got_i, i)
    out_v, out_i = np.empty_like(got_v), np.empty_like(got_i)
    res = native.jitter_jet_normalise(crop_v, crop_i, bf, tir_f, flip, out_v=out_v, out_i=out_i)
    assert res[0] is out_v and res[1] is out_i
    np.testing.assert_array_equal(out_v, got_v)
    with pytest.raises(ValueError):
        native.jitter_jet_normalise(crop_v, crop_i, bf, tir_f, out_v=out_v[:, ::2])


def test_apply_jet_equals_numpy_and_cv2():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    grey = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for x in (img, grey, img[..., 1]):
        np.testing.assert_array_equal(native.apply_jet(x), apply_jet_np(x))
        np.testing.assert_array_equal(native.apply_jet(x, out_bgr=False), apply_jet_np(x)[..., ::-1])
    np.testing.assert_array_equal(native.apply_jet(grey), cv2.applyColorMap(grey, cv2.COLORMAP_JET))


# ----------------------------------------------------------------- batches
def _cfg(get, workers):
    c = get("asymmetric_shared_ce")
    c.update_from_file(RECIPE)
    c.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    c.DATA.VAL.DATASETS_NAME = []
    c.MODEL.BACKBONE.PRETRAINED = False
    c.MODEL.RGBT_PRETRAINED_PATH = ""
    c.DATA.TRAIN.SAMPLE_PER_EPOCH = 12
    c.TRAIN.BATCH_SIZE = 4
    c.TRAIN.NUM_WORKER = workers
    return c


def test_native_loader_batches_equal_plain_and_jax_frames():
    """Three batches of 4 on 4 threads: native == plain for every key; the
    sequences and frames sampled equal the JAX loader's (order aside: the
    threads run the samples in any order)."""
    nat = builders.build_train_loader(_cfg(get_default_config, 4), seed=11)
    plain = builders.build_train_loader(_cfg(get_default_config, 4), seed=11)
    jl, _ = jax_builders.build_dataloaders(_cfg(jax_default_config, 4), seed=11)
    assert nat.sampler.processing.pixels == "native"
    plain.sampler.processing.pixels = "plain"
    ncalls, jcalls = _logged(nat), _logged(jl)
    a, b = list(nat), list(plain)
    list(jl)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert a[0]["search_images_v"].shape == (1, 4, 288, 288, 3)
    assert sorted(ncalls) == sorted(jcalls) and len(ncalls) == 2 * 12


def test_processing_rejects_unknown_pixels():
    with pytest.raises(ValueError, match="pixels"):
        port_pr.RGBTProcessing({}, {}, {}, {}, rng=random.Random(0), pixels="cv2")


# ------------------------------------------------------------------- build
_BUILD = """
import sys
from multi_modal_tracking_torch.ops import _build
print(_build.build_host(sys.argv[1], build_dir=sys.argv[2]))
"""


def test_concurrent_builds_leave_one_good_library(tmp_path):
    src = tmp_path / "data.cpp"
    shutil.copy(native.SOURCE, src)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(src), str(build_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1 and os.listdir(build_dir) == [os.path.basename(paths.pop())]
    import ctypes
    lib = ctypes.CDLL(str(build_dir / os.listdir(build_dir)[0]))
    assert hasattr(lib, "mmt_sample_target") and hasattr(lib, "mmt_jitter_jet_normalise")


def test_broken_source_raises_with_the_compiler_message(tmp_path, monkeypatch):
    src = tmp_path / "data.cpp"
    src.write_text(open(native.SOURCE).read() + "\nint broken( {\n")
    with pytest.raises(RuntimeError, match="error") as e:
        _build.build_host(str(src), build_dir=str(tmp_path / "build"))
    assert "data.cpp" in str(e.value)
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith((".so", ".tmp"))]
    # no path back to numpy: the processing and the Trainer raise
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        builders.build_train_loader(_cfg(get_default_config, 0), seed=0)
    from multi_modal_tracking_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match="error"):
        Trainer("asymmetric_shared_ce", _cfg(get_default_config, 0), save_dir=str(tmp_path),
                device="cpu")
