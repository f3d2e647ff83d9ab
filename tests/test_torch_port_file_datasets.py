"""The port's file-based data path against the JAX package's, on the
miniature dataset trees of tests/test_eval_dataset_layouts.py (`data_root`)
and tests/test_dataset_adapters.py (`roots`) and the in-memory LMDB
environments of tests/test_lmdb_datasets.py:

  * every evaluation set of the registry: the same sequence names, frames,
    ground truth, visibility, classes and depth flags;
  * every training adapter: the same sequence lists and infos, and the same
    frames bit for bit (the port decodes with its own decoder, the JAX
    package with libjpeg and cv2), annotations and meta;
  * `names2datasets` builds every name the JAX registry builds (the LMDB
    twins on fake environments);
  * the DepthTrack depth readers (`_read_depth_as_rgb`,
    `normalized_depth_pair`) on depth maps whose stretched values land on
    0, 255 and other integers exactly, through the float64 clip and the
    uint16 one, bit for bit;
  * the GOT-10k and TrackingNet result zips, file for file;
  * a sequence tracked from JPEG files: the port's boxes from files equal
    its boxes from the same frames as arrays bit for bit, and the JAX
    tracker's on the same files within 0.02 px (f32; the two packages sum
    in different orders, tests/test_torch_port_eval.py argues the bound);
  * `eval.run` on a LasHeR tree, through its CLI.
"""
import json
import os
import zipfile

import cv2
import numpy as np
import pytest

from multi_modal_tracking_tpu.eval import datasets as jax_datasets
from multi_modal_tracking_tpu.eval import packaging as jax_packaging
from multi_modal_tracking_tpu.eval import running as jax_running
from multi_modal_tracking_tpu.train import builders as jax_builders
from multi_modal_tracking_tpu.train.data.datasets import rgbt as jax_rgbt
from multi_modal_tracking_tpu.train.data.datasets import unimodal as jax_unimodal
from multi_modal_tracking_tpu.utils import lmdb_utils as jax_lmdb

from multi_modal_tracking_torch.eval import datasets, packaging, run, running
from multi_modal_tracking_torch.eval.data import RGBTSequence
from multi_modal_tracking_torch.tracking import tracker
from multi_modal_tracking_torch.train import builders
from multi_modal_tracking_torch.train.data.datasets import rgbt as port_rgbt
from multi_modal_tracking_torch.train.data.datasets import unimodal as port_unimodal
from multi_modal_tracking_torch.train.data.datasets.synthetic import SyntheticRGBT
from multi_modal_tracking_torch.utils import lmdb_utils as port_lmdb

from tests.test_dataset_adapters import roots  # noqa: F401 (fixture)
from tests.test_eval_dataset_layouts import data_root  # noqa: F401 (fixture)
from tests.test_lmdb_datasets import _FakeEnv, _jpg
from tests.test_torch_port_eval import KW, _jax_float_trajectories
from tests.test_torch_port_model import GEOM, _pair
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

EVAL_SETS = ["lasher", "rgbt234", "gtot", "vtuav", "vtuav_short", "vtuav_long", "vtuav_train",
             "depthtrack", "lasot", "got10k_test", "got10k_val", "got10k_ltrval",
             "trackingnet", "otb", "uav", "nfs", "tc128", "tc128ce", "tnl2k"]


def _frames_equal(a, b):
    if isinstance(a, (list, tuple)):
        return list(map(tuple, a)) == list(map(tuple, b)) if a and isinstance(
            a[0], (list, tuple)) else list(a) == list(b)
    return a == b


def test_eval_sets_equal_jax(data_root):  # noqa: F811
    """Every set on one tree (it has no VTUAV train split and no GOT-10k val
    sequence: both packages read those as empty)."""
    filled = 0
    for name in EVAL_SETS:
        want, got = jax_datasets.get_dataset(name), datasets.get_dataset(name)
        assert [s.name for s in got] == [s.name for s in want], name
        _assert_sequences_equal(got, want, name)
        filled += len(want) > 0
    assert filled >= len(EVAL_SETS) - 2


def _assert_sequences_equal(got, want, name):
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__, name
        assert (g.dataset, g.object_class) == (w.dataset, w.object_class)
        assert getattr(g, "depth_input", False) == getattr(w, "depth_input", False)
        assert _frames_equal(list(g.frames), list(w.frames)), g.name
        np.testing.assert_array_equal(g.ground_truth_rect, w.ground_truth_rect)
        if w.target_visible is None:
            assert g.target_visible is None
        else:
            np.testing.assert_array_equal(g.target_visible, w.target_visible)
        assert g.init_info() == w.init_info()


ADAPTERS = [
    ("LasHeR", {}), ("RGBT234", {}), ("VTUAV", {}), ("DepthTrack", {"split": "train"}),
    ("KAIST", {}), ("LLVIP", {}), ("M3FD", {}), ("LasHeR_TIR", {}), ("RGBT234_TIR", {}),
    ("LaSOT", {"split": "train"}), ("LaSOT", {"split": None}), ("GOT10k", {"split": "vottrain"}),
    ("GOT10k", {"split": None}), ("TrackingNet", {}), ("TNL2k", {}), ("COCOSeq", {}),
    ("ImagenetVID", {})]
ROOT_OF = {"LasHeR": "lasher", "RGBT234": "rgbt234", "VTUAV": "vtuav",
           "DepthTrack": "depthtrack", "KAIST": "kaist", "LLVIP": "llvip", "M3FD": "m3fd",
           "LasHeR_TIR": "lasher", "RGBT234_TIR": "rgbt234", "LaSOT": "lasot",
           "GOT10k": "got10k", "TrackingNet": "trackingnet", "TNL2k": "tnl2k",
           "COCOSeq": "coco", "ImagenetVID": "imagenet"}


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("cls,kw", ADAPTERS,
                         ids=[f"{c}-{kw.get('split', '')}" for c, kw in ADAPTERS])
def test_training_adapter_equals_jax(roots, cls, kw):  # noqa: F811
    mod_j = jax_rgbt if hasattr(jax_rgbt, cls) else jax_unimodal
    mod_p = port_rgbt if hasattr(port_rgbt, cls) else port_unimodal
    want = getattr(mod_j, cls)(root=roots[ROOT_OF[cls]], **kw)
    got = getattr(mod_p, cls)(root=roots[ROOT_OF[cls]], **kw)
    n = want.get_num_sequences()
    assert n > 0 and got.get_num_sequences() == n and got.get_name() == want.get_name()
    assert got.is_video_sequence() == want.is_video_sequence()
    for seq in range(min(n, 2)):
        wi, gi = want.get_sequence_info(seq), got.get_sequence_info(seq)
        _assert_same(gi, wi, f"{cls} info {seq}")
        last = len(wi["valid"]) - 1
        ids = [0, last] if want.is_video_sequence() else [0, 0]
        _assert_same(got.get_frames(seq, ids, gi), want.get_frames(seq, ids, wi),
                     f"{cls} frames {seq}")


def _lmdb_stores(base):
    """One store per LMDB twin (the layouts of tests/test_lmdb_datasets.py),
    under directories that exist, so that the registry's path check
    passes."""
    rng = np.random.default_rng(6)
    coco = {"images": [{"id": 7, "file_name": "im7.jpg"}],
            "annotations": [{"image_id": 7, "bbox": [3, 4, 5, 6], "iscrowd": 0}]}
    stores = {
        "lasot_lmdb_dir": {"": {"list.txt": b"cat/cat-1\n",
                                "cat/cat-1/groundtruth.txt": b"10,20,30,40\n12,22,28,38\n",
                                "cat/cat-1/full_occlusion.txt": b"0,0",
                                "cat/cat-1/out_of_view.txt": b"0,1",
                                "cat/cat-1/img/00000001.jpg": _jpg(rng),
                                "cat/cat-1/img/00000002.jpg": _jpg(rng)}},
        "got10k_lmdb_dir": {"": {"train/list.txt": b"seq_a\nseq_b\n",
                                 "train/vottrain_split.txt": b"1\n",
                                 "train/votval_split.txt": b"0\n",
                                 "train/seq_b/groundtruth.txt": b"5,6,7,8\n",
                                 "train/seq_b/absence.label": b"0\n",
                                 "train/seq_b/cover.label": b"7\n",
                                 "train/seq_b/00000001.jpg": _jpg(rng),
                                 "train/seq_a/groundtruth.txt": b"1,2,3,4\n",
                                 "train/seq_a/absence.label": b"0\n",
                                 "train/seq_a/cover.label": b"7\n",
                                 "train/seq_a/00000001.jpg": _jpg(rng)}},
        "trackingnet_lmdb_dir": {f"TRAIN_{k}_lmdb": {"list.txt": b"vid1\n",
                                                     "anno/vid1.txt": b"1,2,3,4\n5,6,7,8\n",
                                                     "frames/vid1/0.jpg": _jpg(rng),
                                                     "frames/vid1/1.jpg": _jpg(rng)}
                                 for k in range(4)},
        "coco_lmdb_dir": {"": {"annotations/instances_train2017.json": json.dumps(coco).encode(),
                               "images/train2017/im7.jpg": _jpg(rng)}},
        "imagenet_lmdb_dir": {"": {"cache.json": json.dumps(
            [{"bbox": [[1, 2, 3, 4]], "frames": ["f/0.jpg"], "visible": [True]}]).encode(),
            "f/0.jpg": _jpg(rng)}},
    }
    paths = {}
    for key, subs in stores.items():
        root = os.path.join(base, key)
        for sub, store in subs.items():
            path = os.path.join(root, sub) if sub else root
            os.makedirs(path, exist_ok=True)
            for cache in (jax_lmdb._env_cache, port_lmdb._env_cache):
                cache[path] = _FakeEnv(store)
        paths[key] = root
    return paths


@pytest.fixture
def all_paths(roots, tmp_path, monkeypatch):  # noqa: F811
    """Local paths of every adapter's tree and every LMDB store."""
    paths = {f"{k}_dir": v for k, v in roots.items()}
    paths.update(_lmdb_stores(str(tmp_path / "lmdb")))
    pfile = tmp_path / "local_paths.json"
    pfile.write_text(json.dumps(paths))
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(pfile))
    yield paths
    for cache in (jax_lmdb._env_cache, port_lmdb._env_cache):
        for key in [k for k in cache if k.startswith(str(tmp_path))]:
            cache.pop(key)


def _registry_names():
    """Every name of the JAX registry (its table is local to names2datasets)."""
    import inspect
    import re
    return sorted(set(re.findall(r'^\s+"(\w[\w-]*)": lambda', inspect.getsource(
        jax_builders.names2datasets), re.M)))


def test_names2datasets_builds_every_jax_name(all_paths):
    names = _registry_names()
    assert len(names) == 34 and "LasHeR" in names and "VID_lmdb" in names
    built = 0
    for name in names:
        try:
            want = jax_builders.names2datasets([name])[0]
        except Exception as e:                       # no tree of this split here
            with pytest.raises(type(e)):
                builders.names2datasets([name])
            continue
        got = builders.names2datasets([name])[0]
        assert type(got).__name__ == type(want).__name__, name
        assert got.get_name() == want.get_name(), name
        assert got.get_num_sequences() == want.get_num_sequences(), name
        if want.get_num_sequences():
            f0 = lambda ds: ds.get_frames(0, [0])[0][0]          # noqa: E731
            _assert_same(f0(got), f0(want), name)
        built += 1
    assert built >= 30
    with pytest.raises(ValueError, match="Unknown dataset name"):
        builders.names2datasets(["NoSuchSet"])


def test_lmdb_eval_frames_decode_like_jax(all_paths):
    from multi_modal_tracking_tpu.eval.datasets_rgb import LaSOTLmdbDataset as JaxLmdb
    from multi_modal_tracking_torch.eval.datasets_rgb import LaSOTLmdbDataset
    root = all_paths["lasot_lmdb_dir"]
    want, got = JaxLmdb(root=root).get_sequence_list(), LaSOTLmdbDataset(root=root).get_sequence_list()
    assert [s.name for s in got] == [s.name for s in want] == ["cat-1"]
    for k in range(2):
        assert np.array_equal(running._load_frame(got[0], k), jax_running._load_frame(want[0], k))
    port_lmdb._env_cache[root]._store["nothing"] = b"GIF89a"
    with pytest.raises(ValueError, match="key 'nothing'.*not a JPEG"):
        port_lmdb.decode_img(root, "nothing")


# ------------------------------------------------------------------- depth
def _depth_maps():
    """Maps whose stretched values hit integers exactly: spans that divide
    255, the 0 and 255 ends, a constant map, a uint8 map, and a deep one
    whose clip bound is the int 10000 (the map stays uint16)."""
    rng = np.random.default_rng(11)
    out = [np.arange(256, dtype=np.uint16).reshape(16, 16) + 300,
           (rng.integers(0, 52, (20, 30)) * 5 + 1000).astype(np.uint16),
           (rng.integers(0, 18, (20, 30)) * 15 + 7).astype(np.uint16),
           np.full((5, 7), 4000, np.uint16),
           rng.integers(0, 256, (12, 9)).astype(np.uint8),
           rng.integers(3000, 20000, (20, 30)).astype(np.uint16),
           rng.integers(0, 65536, (25, 19)).astype(np.uint16)]
    out[5][0, 0] = 0
    return out


def test_depth_readers_equal_jax_bit_for_bit(tmp_path):
    color = str(tmp_path / "c.jpg")
    cv2.imwrite(color, np.random.default_rng(1).integers(0, 255, (5, 7, 3), np.uint8))
    on_integer = 0
    for k, dp in enumerate(_depth_maps()):
        path = str(tmp_path / f"d{k}.png")
        assert cv2.imwrite(path, dp)
        want = jax_running._read_depth_as_rgb(path)
        got = running._read_depth_as_rgb(path)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), k
        if dp.shape == (5, 7):
            for clip in (True, False):
                w = jax_rgbt.normalized_depth_pair(color, path, depth_clip=clip)
                g = port_rgbt.normalized_depth_pair(color, path, depth_clip=clip)
                assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]), clip
        d = dp.astype(np.float64)
        max_depth = min(np.median(dp) * 3, 10000)
        d = np.minimum(d, max_depth)
        if d.max() > d.min():
            exact = (d - d.min()) * 255 / (d.max() - d.min())
            on_integer += int((exact == np.round(exact)).sum())
    assert on_integer > 500


# --------------------------------------------------------------- packaging
def test_result_zips_equal_jax(tmp_path):
    res = tmp_path / "res"
    res.mkdir()
    rng = np.random.default_rng(3)
    for name in ("GOT-10k_Test_000001", "GOT-10k_Test_000002"):
        np.savetxt(res / f"{name}.txt", rng.uniform(0, 300, (6, 4)), fmt="%d", delimiter="\t")
        np.savetxt(res / f"{name}_time.txt", rng.uniform(0, 1, 6), fmt="%f")
        np.savetxt(res / f"{name}_score.txt", rng.uniform(0, 1, 6), fmt="%.2f")
    for fn in ("transform_got10k", "transform_trackingnet"):
        zips = [getattr(mod, fn)(str(res), str(tmp_path / f"{tag}_{fn}"), "tracker")
                for mod, tag in ((jax_packaging, "jax"), (packaging, "port"))]
        contents = []
        for z in zips:
            with zipfile.ZipFile(z) as f:
                contents.append({n: f.read(n) for n in f.namelist()})
        assert contents[0] == contents[1] and len(contents[0]) >= 2, fn


# ------------------------------------------------------------ tracking
@pytest.fixture(scope="module")
def pair():
    return _pair(GEOM, 51)


def _write_sequence(folder, k, n_frames=9):
    """A LasHeR-layout sequence of JPEG pairs of SyntheticRGBT's sequence k
    (240 x 320, quality 95): (the RGB-T sequence of paths, the frames as
    JAX's libjpeg decoder reads them)."""
    fv, fi, boxes = SyntheticRGBT(k + 1, n_frames, 240, 320)._seq(k)
    base = os.path.join(folder, f"seq{k:02d}")
    paths = []
    for t in range(n_frames):
        pv, pi = (os.path.join(base, d, f"{t:06d}.jpg") for d in ("visible", "infrared"))
        for p, img in ((pv, fv[t]), (pi, fi[t])):
            os.makedirs(os.path.dirname(p), exist_ok=True)
            cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append((pv, pi))
    np.savetxt(os.path.join(base, "init.txt"), boxes, fmt="%d", delimiter=",")
    gt = np.stack([boxes, boxes], axis=1).astype(np.float64)
    return paths, gt


def test_tracked_from_files_equals_arrays_and_jax(pair, tmp_path):
    from multi_modal_tracking_tpu import native as jax_native
    from multi_modal_tracking_tpu.eval.data import RGBTSequence as JaxRGBTSequence
    jmodel, variables, pmodel = pair
    paths, gt = _write_sequence(str(tmp_path / "data"), 1)
    seq = RGBTSequence("seq01", paths, "LasHeR", gt)
    decoded = [[jax_native.decode_jpeg(p) for p in pv_pi] for pv_pi in paths]
    arrays = RGBTSequence("seq01", [tuple(f) for f in decoded], "LasHeR", gt)
    stats = {}
    for tag, s in (("files", seq), ("arrays", arrays)):
        pt = tracker.RGBTCachedTracker(pmodel, device="cpu", **KW)
        stats[tag] = running.run_dataset([s], pt, str(tmp_path / tag), chunk=4)[0]
    np.testing.assert_array_equal(stats["files"]["boxes"], stats["arrays"]["boxes"])
    assert (tmp_path / "files" / "seq01.txt").read_bytes() == \
        (tmp_path / "arrays" / "seq01.txt").read_bytes()
    jseq = JaxRGBTSequence("seq01", [tuple(f) for f in decoded], "LasHeR", gt)
    want = _jax_float_trajectories(jmodel, variables, [jseq])["seq01"]
    np.testing.assert_allclose(stats["files"]["boxes"], want, rtol=0, atol=0.02)


def test_eval_run_cli_on_a_lasher_tree(pair, tmp_path, monkeypatch, capsys):
    """`python -m multi_modal_tracking_torch.eval.run ... --dataset_name
    lasher` on a LasHeR TestingSet tree (create_tracker builds the tiny
    model on the CPU): one result file per sequence, the frames decoded
    from files; the GOT-10k zip of its results."""
    root = tmp_path / "lasher"
    for k in (0, 1):
        _write_sequence(str(root / "TestingSet" / "testingset"), k, n_frames=5)
    local = tmp_path / "local_paths.json"
    local.write_text(json.dumps({"lasher_dir": str(root), "results_path": str(tmp_path / "out")}))
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(local))

    def tiny(params, dataset_name="", device="cuda", **kw):
        return tracker.RGBTCachedTracker(pair[2], template_factor=params.template_factor,
                                         template_size=KW["template_size"],
                                         search_factor=params.search_factor,
                                         search_size=KW["search_size"], update_interval=3,
                                         device=device)
    monkeypatch.setattr(run, "create_tracker", tiny)
    out = run.main(["asymmetric_shared_ce", "attention_lasher_newfusion_2layer", "--device",
                    "cpu", "--chunk", "4", "--dtype", "float32", "--dataset_name", "lasher",
                    "--results_dir", str(tmp_path / "res")])
    assert out == [str(tmp_path / "res" / "lasher")]
    for k in (0, 1):
        boxes = np.loadtxt(tmp_path / "res" / "lasher" / f"seq{k:02d}.txt")
        assert boxes.shape == (5, 4) and np.isfinite(boxes).all()
    assert "2 / 2 sequences" in capsys.readouterr().out
    z = packaging.transform_got10k(out[0], str(tmp_path / "zip"), "tiny")
    with zipfile.ZipFile(z) as f:
        assert sorted(n for n in f.namelist() if not n.endswith("/")) == sorted(
            f"seq{k:02d}/seq{k:02d}_{s}.txt" for k in (0, 1) for s in ("001", "time"))
