"""The port's training data pipeline (TrackingSampler + RGBTProcessing +
Loader on SyntheticRGBT, numpy only) against the JAX package's (which uses
cv2), with the same seed, on the flagship recipe's sampling settings
(trident_pro, two templates, search factor 4.5 at 288, template 128).

Tolerances: the sampled sequences and frame ids must be the same; boxes
within 1e-6; images within one grey level (1/255 on the 0..1 scale) once
the ImageNet normalisation is undone. The port reproduces cv2's uint8
bilinear resize (11-bit fixed-point coefficients) bit for bit on these
crops, which the crop tests below check exactly, so the images in fact
agree to float rounding.
"""
import cv2
import numpy as np
import pytest

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.train import builders as jax_builders
from multi_modal_tracking_tpu.train.data import loader as jax_loader
from multi_modal_tracking_tpu.train.data import processing_utils as jax_pu

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.train import builders
from multi_modal_tracking_torch.train.data import loader as port_loader
from multi_modal_tracking_torch.train.data import processing_utils as port_pu
from multi_modal_tracking_torch.train.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RECIPE = "experiments/asymmetric_shared_ce/attention_lasher_newfusion_2layer.yaml"


def _cfg(get):
    c = get("asymmetric_shared_ce")
    c.update_from_file(RECIPE)
    c.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    c.DATA.VAL.DATASETS_NAME = []
    c.DATA.TRAIN.SAMPLE_PER_EPOCH = 6
    c.TRAIN.BATCH_SIZE = 2
    c.TRAIN.NUM_WORKER = 0
    return c


def _logged(loader):
    calls = []
    ds = loader.sampler.datasets[0]
    orig = ds.get_frames

    def get_frames(seq_id, frame_ids, anno=None):
        calls.append((seq_id, tuple(int(f) for f in frame_ids)))
        return orig(seq_id, frame_ids, anno)
    ds.get_frames = get_frames
    return calls


@pytest.fixture(scope="module")
def batches():
    jl, _ = jax_builders.build_dataloaders(_cfg(jax_default_config), seed=3)
    pl = builders.build_train_loader(_cfg(get_default_config), seed=3)
    jcalls, pcalls = _logged(jl), _logged(pl)
    return list(jl), jcalls, list(pl), pcalls


def test_same_sequences_and_frames(batches):
    jb, jcalls, pb, pcalls = batches
    assert len(jb) == len(pb) == 3
    assert pcalls == jcalls and len(pcalls) == 2 * 6


def test_same_boxes_and_images(batches):
    jb, _, pb, _ = batches
    for j, p in zip(jb, pb):
        assert j.keys() == p.keys()
        for k in j:
            assert j[k].shape == p[k].shape and j[k].dtype == p[k].dtype, k
            if "anno" in k:
                np.testing.assert_allclose(p[k], j[k], atol=1e-6, rtol=0, err_msg=k)
            elif "images" in k:
                unnorm = lambda x: x * IMAGENET_STD + IMAGENET_MEAN   # noqa: E731
                np.testing.assert_allclose(unnorm(p[k]), unnorm(j[k]), atol=1 / 255, rtol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_batch_to_model_inputs_keys_and_shapes(batches):
    jb, _, pb, _ = batches
    j = jax_loader.batch_to_model_inputs(jb[0], rgbt=True)
    p = port_loader.batch_to_model_inputs(pb[0], rgbt=True)
    assert j.keys() == p.keys()
    assert {k: v.shape for k, v in j.items()} == {k: v.shape for k, v in p.items()}
    assert p["search_v"].shape == (2, 288, 288, 3) and p["template_v"].shape == (2, 128, 128, 3)


@pytest.mark.parametrize("src", [60, 61, 77, 143, 200, 300, 576])
@pytest.mark.parametrize("dst", [128, 288])
def test_resize_reproduces_cv2(src, dst):
    rng = np.random.default_rng(src * dst)
    img = rng.integers(0, 256, (src, src, 3), dtype=np.uint8)
    np.testing.assert_array_equal(port_pu.resize_linear(img, dst), cv2.resize(img, (dst, dst)))
    mask = (rng.random((src, src)) < 0.3).astype(np.float64)
    np.testing.assert_array_equal(port_pu.resize_linear(mask, dst).astype(bool),
                                  cv2.resize(mask, (dst, dst)).astype(bool))
    np.testing.assert_array_equal(
        port_pu.resize_nearest(mask > 0, dst // 16),
        cv2.resize(mask.astype(np.float32), (dst // 16, dst // 16),
                   interpolation=cv2.INTER_NEAREST) > 0.5)


def test_sample_target_matches_cv2_crops():
    """Random windows, partly outside the frame: crop, resize factor and
    padding mask equal to the cv2 version's."""
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    n = 0
    for _ in range(60):
        box = [rng.uniform(-20, 300), rng.uniform(-20, 220), rng.uniform(5, 120),
               rng.uniform(5, 120)]
        factor, out = float(rng.choice([2.0, 4.5])), int(rng.choice([128, 288]))
        try:
            want = jax_pu.sample_target(im, box, factor, out)
        except Exception:                          # an empty window: both refuse it
            with pytest.raises(ValueError):
                port_pu.sample_target(im, box, factor, out)
            continue
        got = port_pu.sample_target(im, box, factor, out)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        n += 1
    assert n > 40


def test_unported_dataset_names_raise(tmp_path, monkeypatch):
    """The file-based adapters are ported (tests/test_torch_port_file_datasets.py
    reads them from trees): with no path configured, LasHeR raises as the
    JAX package's does; an unknown name raises ValueError."""
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(tmp_path / "none.json"))
    with pytest.raises(RuntimeError, match="lasher_dir"):
        builders.names2datasets(["LasHeR"])
    with pytest.raises(ValueError, match="Unknown"):
        builders.names2datasets(["NoSuchSet"])
