"""The port's command-line tools (multi_modal_tracking_torch.tools) against
the JAX package's root scripts (tracking/*.py, run by file path, unedited)
on the same inputs, on the CPU:

  * fps, the analysis tables (analysis_results and its VTUAV wrapper on a
    synthetic set, ITP, cross-dataset): equal standard output;
  * analysis_results_plot: the same file names, and the same PNG bytes
    (the same curves, labels and scores drawn by the same matplotlib);
  * create_default_local_file: the same file; pre_read_datasets: the same
    output but for the seconds;
  * profile_model (device cpu, a narrow flagship): the parameter count of
    the JAX script's way (the `params` leaves) and the JAX walker's FLOPs;
  * gen_video / gen_video_uavtir, imgs2video, video2imgs: the same decoded
    frames or files; vis_attn, search_vis and video_demo on a tiny model:
    their files, and ImportError without cv2 where they need it.
"""
import contextlib
import io
import json
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.utils.flops import matmul_conv_flops as jax_flops

from multi_modal_tracking_torch import native
from multi_modal_tracking_torch.eval import datasets
from multi_modal_tracking_torch.tools import (analysis_results, analysis_results_crossdatasets,
                                              analysis_results_ITP, analysis_results_plot,
                                              analysis_results_vtuav, create_default_local_file,
                                              fps, gen_video, gen_video_uavtir, imgs2video,
                                              pre_read_datasets, profile_model, search_vis,
                                              video2imgs, video_demo, vis_attn)
from tests.test_dataset_adapters import roots  # noqa: F401 (fixture)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "tracking")


def _jax_script(name, argv, monkeypatch):
    """stdout of `python tracking/<name>.py argv` (in process; the script's
    directory first on the path, as python puts it)."""
    monkeypatch.syspath_prepend(SCRIPTS)
    monkeypatch.setattr(sys, "argv", [os.path.join(SCRIPTS, name + ".py")] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(SCRIPTS, name + ".py"), run_name="__main__")
    return out.getvalue()


def _port_tool(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(argv))
    return out.getvalue()


@pytest.fixture(scope="module")
def results_tree(tmp_path_factory):
    """Two trackers' result files (tab-separated integers, as the runners
    write) for synthetic_rgbt and synthetic_rgb, and time files."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(0)
    for ds_name in ("synthetic_rgbt", "synthetic_rgb"):
        for seq in datasets.get_dataset(ds_name):
            gt = np.asarray(seq.ground_truth_rect, np.float64)
            gt = gt[:, 0] if gt.ndim == 3 else gt
            for tracker, noise in (("trkA", 2.0), ("trkB", 9.0)):
                d = root / "script" / tracker / ds_name
                d.mkdir(parents=True, exist_ok=True)
                boxes = gt + rng.normal(0.0, noise, gt.shape)
                boxes[:, 2:] = np.maximum(boxes[:, 2:], 1.0)
                np.savetxt(d / f"{seq.name}.txt", boxes, delimiter="\t", fmt="%d")
                np.savetxt(d / f"{seq.name}_time.txt", rng.uniform(0.005, 0.02, len(gt)),
                           fmt="%f")
    return root


def test_fps_equals_jax(results_tree, monkeypatch):
    d = str(results_tree / "script" / "trkA" / "synthetic_rgbt")
    want = _jax_script("fps", [d], monkeypatch)
    assert _port_tool(fps.main, [d]) == want and "FPS" in want
    frames, seconds = fps.fps(d)
    assert want.startswith(f"{frames} frames")


@pytest.mark.parametrize("extra", [[], ["--per_sequence"]], ids=["table", "per_sequence"])
def test_analysis_results_equals_jax(results_tree, monkeypatch, extra):
    argv = ["--dataset_name", "synthetic_rgbt", "--results_glob",
            str(results_tree / "script" / "*")] + extra
    want = _jax_script("analysis_results", argv, monkeypatch)
    assert _port_tool(analysis_results.main, argv) == want and "trkB" in want


def test_analysis_results_vtuav_wrapper_equals_jax(results_tree, monkeypatch):
    """The wrapper's defaults apply only where a flag is missing: here every
    flag is given (the VTUAV files are not in the repository)."""
    argv = ["--dataset_name", "synthetic_rgb", "--dataset_split", "",
            "--results_glob", str(results_tree / "script" / "*")]
    want = _jax_script("analysis_results_vtuav", argv, monkeypatch)
    assert _port_tool(analysis_results_vtuav.main, argv) == want and "trkA" in want


def test_analysis_results_itp_equals_jax(results_tree, monkeypatch):
    argv = ["--results_root", str(results_tree), "--tracker_names", "script/trkA",
            "script/trkB", "--dataset_name", "synthetic_rgbt", "--per_sequence"]
    want = _jax_script("analysis_results_ITP", argv, monkeypatch)
    assert _port_tool(analysis_results_ITP.main, argv) == want and "script/trkA" in want


def test_analysis_results_crossdatasets_equals_jax(results_tree, monkeypatch):
    argv = ["--datasets_name", "synthetic_rgbt", "synthetic_rgb", "--results_glob",
            str(results_tree / "script" / "*")]
    want = _jax_script("analysis_results_crossdatasets", argv, monkeypatch)
    assert _port_tool(analysis_results_crossdatasets.main, argv) == want
    assert "AUC/Precision" in want


def test_analysis_results_plot_equals_jax(results_tree, monkeypatch, tmp_path):
    base = ["--dataset_name", "synthetic_rgbt", "--results_glob",
            str(results_tree / "script" / "trkA"), "--external_glob",
            str(results_tree / "script" / "trkB")]
    want = _jax_script("analysis_results_plot", base + ["--plot_dir", str(tmp_path / "j")],
                       monkeypatch)
    got = _port_tool(analysis_results_plot.main, base + ["--plot_dir", str(tmp_path / "p")])
    assert got.replace(str(tmp_path / "p"), "") == want.replace(str(tmp_path / "j"), "")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    for n in names:
        if n.endswith(".png"):
            assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


def test_plot_needs_matplotlib(results_tree, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        analysis_results_plot.main(["--dataset_name", "synthetic_rgbt", "--results_glob",
                                    str(results_tree / "script" / "*"), "--plot_dir",
                                    str(tmp_path)])


def test_create_default_local_file_equals_jax(monkeypatch, tmp_path):
    argv = ["--workspace_dir", "/ws", "--data_dir", "/data", "--save_dir", "/out"]
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(tmp_path / "jax.json"))
    want = _jax_script("create_default_local_file", argv, monkeypatch)
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(tmp_path / "port.json"))
    got = _port_tool(create_default_local_file.main, argv)
    assert got.replace("port.json", "") == want.replace("jax.json", "")
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))


def test_pre_read_datasets_equals_jax(roots, monkeypatch, tmp_path):  # noqa: F811
    """On the adapters' file trees of tests/test_dataset_adapters.py, read
    through each package's own decoder."""
    pfile = tmp_path / "local_paths.json"
    pfile.write_text(json.dumps({f"{k}_dir": v for k, v in roots.items()}))
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(pfile))
    argv = ["--datasets", "LasHeR", "RGBT234", "LASOT"]
    strip = lambda s: [ln.split(" in ")[0] for ln in s.splitlines()]   # noqa: E731
    want = _jax_script("pre_read_datasets", argv, monkeypatch)
    got = _port_tool(pre_read_datasets.main, argv)
    assert strip(got) == strip(want) and "warmed" in want


# ------------------------------------------------------------- profile_model
TINY = dict(embed_dim=64, depth=2, num_heads=4, head_dim=64, fusion_layers=1,
            ce_loc=(1,), ce_keep_ratio=(0.7,))


def test_profile_model_equals_jax_counts(capsys):
    """Parameters counted as the JAX script counts them (the `params`
    leaves of the model's variables) and the forward's FLOPs as the JAX
    walker counts them, at search 128 / template 64 on a narrow flagship."""
    from multi_modal_tracking_tpu.config import get_default_config as jax_cfg
    got = profile_model.profile("asymmetric_shared_ce", 128, 64, repeats=1, device="cpu",
                                spec_overrides=TINY)
    cfg = jax_cfg("asymmetric_shared_ce")
    cfg.DATA.SEARCH.SIZE, cfg.DATA.TEMPLATE.SIZE = 128, 64
    spec = jax_as.RGBTSpec.from_cfg(cfg)
    jm = jax_as.MixFormerRGBT(spec=type(spec)(**dict(spec.__dict__, **TINY)))
    t = jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.float32)
    s = jax.ShapeDtypeStruct((2, 128, 128, 3), jnp.float32)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), t, t, s)
    assert got["params"] == sum(int(np.prod(p.shape))
                                for p in jax.tree.leaves(variables["params"]))
    assert got["flops"] == jax_flops(lambda v, a, b, c: jm.apply(v, a, b, c)["pred_boxes"],
                                     variables, t, t, s)
    assert got["latency_ms"] > 0
    out = capsys.readouterr().out
    assert "analytic matmul+conv count" in out and "params:" in out


# ------------------------------------------------------------------ videos
def test_gen_video_equals_jax(results_tree, monkeypatch, tmp_path):
    """The same decoded frames (same frames in, the same encoder), on the
    RGB frames and, through the uavtir wrapper, the TIR ones."""
    import cv2
    res = ["mine=" + str(results_tree / "script" / "trkA")]
    for jax_name, port_main, extra in (("gen_video", gen_video.main, []),
                                       ("gen_video_uavtir", gen_video_uavtir.main, [])):
        argv = ["--dataset_name", "synthetic_rgbt", "--sequence", "synthetic_01",
                "--results"] + res + extra
        _jax_script(jax_name, argv + ["--out_dir", str(tmp_path / ("j" + jax_name))],
                    monkeypatch)
        _port_tool(port_main, argv + ["--out_dir", str(tmp_path / ("p" + jax_name))])
        names = os.listdir(tmp_path / ("j" + jax_name))
        assert os.listdir(tmp_path / ("p" + jax_name)) == names
        caps = [cv2.VideoCapture(str(tmp_path / (w + jax_name) / names[0])) for w in "jp"]
        n = 0
        while True:
            (ok_j, fj), (ok_p, fp) = (c.read() for c in caps)
            assert ok_j == ok_p
            if not ok_j:
                break
            np.testing.assert_array_equal(fp, fj)
            n += 1
        assert n == 40


def test_imgs2video_and_video2imgs_equal_jax(monkeypatch, tmp_path):
    import cv2
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(1)
    for k in range(6):
        cv2.imwrite(str(imgs / f"{k}.png"), rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    _jax_script("imgs2video", [str(imgs), str(tmp_path / "j.mp4")], monkeypatch)
    _port_tool(imgs2video.main, [str(imgs), str(tmp_path / "p.mp4")])
    assert (tmp_path / "p.mp4").read_bytes() == (tmp_path / "j.mp4").read_bytes()
    _jax_script("video2imgs", [str(tmp_path / "j.mp4"), str(tmp_path / "jf")], monkeypatch)
    _port_tool(video2imgs.main, [str(tmp_path / "j.mp4"), str(tmp_path / "pf")])
    names = sorted(os.listdir(tmp_path / "jf"))
    assert sorted(os.listdir(tmp_path / "pf")) == names and len(names) == 6
    for n in names:
        assert (tmp_path / "pf" / n).read_bytes() == (tmp_path / "jf" / n).read_bytes()


def test_video_tools_need_cv2(results_tree, monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        imgs2video.imgs2video(str(tmp_path), str(tmp_path / "v.mp4"))
    with pytest.raises(ImportError, match="cv2"):
        video2imgs.video2imgs(str(tmp_path / "v.mp4"), str(tmp_path / "f"))
    with pytest.raises(ImportError, match="cv2"):
        gen_video.main(["--dataset_name", "synthetic_rgbt", "--sequence", "synthetic_01",
                        "--results", "mine=" + str(results_tree / "script" / "trkA"),
                        "--out_dir", str(tmp_path)])
    with pytest.raises(ImportError, match="cv2"):
        video_demo.main(["mixformer_vit", "baseline", str(tmp_path), "--device", "cpu"])


# ------------------------------------------- tools that track, on a tiny model
SPECS = {"asymmetric_shared_ce": dict(search_size=64, template_size=32, embed_dim=32, depth=2,
                                      num_heads=2, head_dim=32, fusion_layers=1,
                                      ce_loc=(1,), ce_keep_ratio=(0.7,)),
         "mixformer_vit": dict(search_size=64, template_size=32, embed_dim=32, depth=1,
                               num_heads=2, head_dim=32)}


@pytest.fixture
def tiny(monkeypatch):
    """create_tracker builds a narrow model (the spec above) at the small
    crops, on the CPU at f32."""
    from multi_modal_tracking_torch.eval import evaltracker
    orig = evaltracker.build_model
    monkeypatch.setattr(evaltracker, "build_model", lambda script, cfg, **kw: orig(
        script, cfg, spec_overrides=SPECS[script], **kw))
    from multi_modal_tracking_torch.eval import params as params_mod
    get = params_mod.get_parameters

    def small(*a, **kw):
        p = get(*a, **kw)
        p.template_size, p.search_size = 32, 64
        return p
    monkeypatch.setattr(params_mod, "get_parameters", small)
    return small


def test_vis_attn_and_search_vis_write_panels(tiny, tmp_path):
    out = vis_attn.main(["asymmetric_shared_ce", "attention_lasher_newfusion_2layer",
                         "--dataset_name", "synthetic_rgbt", "--sequence", "synthetic_01",
                         "--frames", "2", "3", "--out_dir", str(tmp_path / "a"),
                         "--device", "cpu", "--dtype", "float32"])
    assert [os.path.basename(p) for p in out] == ["attn_block01_0002.png",
                                                  "attn_block01_0003.png"]
    assert native.imread(out[0]).shape == (144, 288, 3)
    out = search_vis.main(["--scripts", "asymmetric_shared_ce", "--dataset_name",
                           "synthetic_rgbt", "--frames", "0", "4", "--out",
                           str(tmp_path / "s"), "--device", "cpu", "--dtype", "float32"])
    assert [os.path.basename(p) for p in out] == ["asymmetric_shared_ce_0000.png",
                                                  "asymmetric_shared_ce_0004.png"]
    assert native.imread(out[1]).shape == (144, 432, 3)


def test_video_demo_tracks_an_image_directory(tiny, tmp_path):
    import cv2
    seq = datasets.get_dataset("synthetic_rgb", n_sequences=1, n_frames=5)[0]
    d = tmp_path / "frames"
    d.mkdir()
    for k, f in enumerate(seq.frames):
        cv2.imwrite(str(d / f"{k:04d}.png"), f[..., ::-1])
    (d / "notes.txt").write_text("not an image")
    box = [str(v) for v in seq.ground_truth_rect[0]]
    out = video_demo.main(["mixformer_vit", "baseline", str(d), "--optional_box", *box,
                           "--out", str(tmp_path / "demo.mp4"), "--device", "cpu",
                           "--dtype", "float32"])
    assert int(cv2.VideoCapture(out).get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    with pytest.raises(SystemExit, match="optional_box"):
        video_demo.main(["mixformer_vit", "baseline", str(d), "--device", "cpu"])
