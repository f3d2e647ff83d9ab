"""The port stands alone: it imports neither JAX, flax, the JAX package,
msgpack nor cv2 (the last two are absent on the machine with the GPU), and
its entry points run on the GPU or raise — they never fall back to the CPU
on their own. Options that are not ported raise; the ones that are (a
checkpoint for the tracker, ACCUM_ITER, the val split, checkpoints and the
fail-safe restart) work. The eval stack (eval/ and tracking/batched.py) is
covered alike. The port's C++ and CUDA sources include nothing outside
multi_modal_tracking_torch/csrc/, in particular nothing of the repo's
native/."""
import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "multi_modal_tracking_torch")
FORBIDDEN = ("jax", "flax", "multi_modal_tracking_tpu", "cv2", "msgpack")


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def _cxx_sources():
    for dirpath, _, files in os.walk(os.path.join(PORT, "csrc")):
        for f in files:
            if f.endswith((".cpp", ".cu", ".cuh", ".h", ".hpp")):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_cxx_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_cxx_sources_include_nothing_outside_csrc(path):
    """The port's C++ and CUDA sources include only system headers and files
    under multi_modal_tracking_torch/csrc/: nothing of the repo's native/
    (the JAX package's host runtime) or of anything else in the repo."""
    csrc = os.path.join(PORT, "csrc")
    for line in open(path):
        m = re.match(r'\s*#\s*include\s*([<"])([^>"]+)[>"]', line)
        if not m:
            continue
        name = m.group(2)
        assert "native" not in name and "mmtrk" not in name and "jet_lut" not in name, line
        if m.group(1) == '"':
            target = os.path.realpath(os.path.join(os.path.dirname(path), name))
            assert target.startswith(csrc + os.sep) and os.path.isfile(target), line


def test_host_build_reaches_nothing_outside_csrc():
    from multi_modal_tracking_torch import native
    from multi_modal_tracking_torch.ops import _build
    assert not [f for f in _build.HOST_FLAGS if f.startswith(("-I", "-L", "-l", "-include"))]
    for src in (native.SOURCE, native.IMAGE_SOURCE):
        assert os.path.realpath(src).startswith(os.path.join(PORT, "csrc", "host") + os.sep)


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import multi_modal_tracking_torch.eval.evaltracker as e\n"
            "import multi_modal_tracking_torch.tracking.tracker, "
            "multi_modal_tracking_torch.utils.convert\n"
            "import multi_modal_tracking_torch.train.trainer, "
            "multi_modal_tracking_torch.train.run, multi_modal_tracking_torch.utils.checkpoint\n"
            "import multi_modal_tracking_torch.eval.run, multi_modal_tracking_torch.eval.running, "
            "multi_modal_tracking_torch.eval.analysis, multi_modal_tracking_torch.eval.metrics, "
            "multi_modal_tracking_torch.eval.datasets, "
            "multi_modal_tracking_torch.eval.datasets_rgbt, "
            "multi_modal_tracking_torch.eval.data, multi_modal_tracking_torch.tracking.batched\n"
            "from multi_modal_tracking_torch.eval.datasets import get_dataset\n"
            "get_dataset('synthetic_rgbt_hard', n_sequences=1, n_frames=2)\n"
            "import multi_modal_tracking_torch.eval.datasets_rgb, "
            "multi_modal_tracking_torch.eval.packaging, multi_modal_tracking_torch.utils.depth\n"
            "from multi_modal_tracking_torch.train import builders\n"
            "from multi_modal_tracking_torch.train.data.datasets import rgbt, unimodal, lmdb_twins\n"
            "from multi_modal_tracking_torch import native\n"
            "native.imread('tests/torch_port_images/1x1.jpg')\n"
            "native.imread('tests/torch_port_images/palette.png')\n"
            "from multi_modal_tracking_torch.eval.evaltracker import create_tracker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multi_modal_tracking_tpu', 'cv2', 'msgpack')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_eval_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The lockstep trackers and the eval CLI, like create_tracker."""
    from multi_modal_tracking_torch.eval import run
    from multi_modal_tracking_torch.tracking.batched import (BatchedOnlineTracker,
                                                             BatchedRGBCachedTracker,
                                                             BatchedRGBTCachedTracker,
                                                             BatchedRGBTracker,
                                                             BatchedRGBTTracker)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (BatchedRGBTTracker, BatchedRGBTCachedTracker, BatchedRGBTracker,
                BatchedRGBCachedTracker, BatchedOnlineTracker):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["asymmetric_shared_ce", "attention_lasher_newfusion_2layer",
                  "--sequence", "synthetic_00"])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.tracking.tracker import (OnlineTracker, RGBCachedTracker,
                                                             RGBTCachedTracker, RGBTracker,
                                                             RGBTTracker)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_tracker(params, "LasHeR")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("asymmetric_shared_ce", params.cfg)
    model = torch.nn.Linear(2, 2)
    for cls in (RGBTTracker, RGBTCachedTracker, RGBTracker, RGBCachedTracker, OnlineTracker):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(model)
    params = get_parameters("mixformer_vit_online", "baseline")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_tracker(params, "LasOT", mode="TIR")


TINY = dict(embed_dim=32, depth=1, num_heads=2, head_dim=32, fusion_layers=1, ce_loc=None,
            ce_keep_ratio=None)


def _tiny_builder(monkeypatch, overrides):
    """create_tracker builds its model with `overrides` on the spec."""
    from multi_modal_tracking_torch.eval import evaltracker
    orig = evaltracker.build_model
    monkeypatch.setattr(evaltracker, "build_model", lambda *a, **kw: orig(
        *a, spec_overrides=overrides, **kw))


def test_unported_options_raise(tmp_path, monkeypatch):
    """A compute dtype other than float32 and bfloat16 and
    CE_TEMPLATE_RANGE still raise (bfloat16 is ported for tracking and
    evaluation: tests/test_torch_port_tracker_bf16.py); the online script
    builds its score branch (tests/test_torch_port_spm.py); a checkpoint for
    the tracker is ported: it loads strictly (all weights equal the
    file's), and one that does not cover the model raises."""
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.models.build import build_model

    params = get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")
    with pytest.raises(NotImplementedError, match="dtype"):
        build_model("asymmetric_shared_ce", params.cfg, device="cpu", dtype=torch.float16)
    online = build_model("asymmetric_shared_online", params.cfg, device="cpu",
                         spec_overrides=TINY)
    assert online.with_score and hasattr(online, "score_branch")
    from multi_modal_tracking_torch.models.asymmetric_shared import AsymSharedViT
    # the CE template-range modes are ported (tests/test_torch_port_ce_modes.py);
    # a mode that is none of them raises, as in the JAX package
    assert AsymSharedViT(ce_template_range="CTR_REC").ce_template_range == "CTR_REC"
    with pytest.raises(ValueError, match="CE_TEMPLATE_RANGE"):
        AsymSharedViT(ce_template_range="CTR_RECT")

    sd = build_model("asymmetric_shared_ce", params.cfg, device="cpu", seed=3,
                     spec_overrides=TINY).state_dict()
    params.checkpoint = str(tmp_path / "MixFormerRGBT_ep0001.pth.tar")
    torch.save({"epoch": 1, "net": sd}, params.checkpoint)
    _tiny_builder(monkeypatch, TINY)
    tracker = create_tracker(params, device="cpu", dtype=torch.float32)
    got = tracker.model.state_dict()
    assert got.keys() == sd.keys() and all(torch.equal(got[k], sd[k]) for k in sd)
    torch.save({"net": {k: v for k, v in sd.items() if "box_head" not in k}}, params.checkpoint)
    with pytest.raises(ValueError, match="strict"):
        create_tracker(params, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("script", ["mixformer_cvt", "mixformer_cvt_online", "mixformer_convmae",
                                    "mixformer_convmae_online"])
def test_unported_scripts_raise(script):
    """Every script of the repo is ported: the CvT and ConvMAE ones build
    from their configs (tests/test_torch_port_cvt.py and
    tests/test_torch_port_convmae.py hold them to the JAX package), and a
    name the registry lacks raises in get_default_config and build_model."""
    from multi_modal_tracking_torch.config import get_default_config
    from multi_modal_tracking_torch.models.build import SCRIPTS, build_model
    cfg = get_default_config(script)
    tiny = (dict(dim_embed=(16, 32, 64), num_heads=(1, 2, 4), depth=(1, 1, 2), head_dim=64)
            if "cvt" in script else dict(embed_dim=(32, 48, 64), depth=(1, 1, 2), num_heads=4,
                                         head_dim=64))
    model = build_model(script, cfg, device="cpu", spec_overrides=dict(
        tiny, search_size=64, template_size=32))
    assert script in SCRIPTS and model.with_score == script.endswith("_online")
    with pytest.raises(KeyError, match="unknown script"):
        get_default_config(script + "_x")
    with pytest.raises(KeyError, match="unknown script"):
        build_model(script + "_x", cfg, device="cpu")


def _train_cfg(small: bool = False):
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config("asymmetric_shared_ce")
    cfg.update_from_file(os.path.join(ROOT, "experiments", "asymmetric_shared_ce",
                                      "attention_lasher_newfusion_2layer.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.RGBT_PRETRAINED_PATH = ""
    cfg.TRAIN.NUM_WORKER = 0
    if small:
        cfg.DATA.SEARCH.SIZE, cfg.DATA.TEMPLATE.SIZE = 64, 32
        cfg.DATA.TRAIN.SAMPLE_PER_EPOCH = cfg.DATA.VAL.SAMPLE_PER_EPOCH = 2
        cfg.TRAIN.BATCH_SIZE = 2
    return cfg


def test_training_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    from multi_modal_tracking_torch.train import run
    from multi_modal_tracking_torch.train.train_step import make_eval_step, make_train_step
    from multi_modal_tracking_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer("asymmetric_shared_ce", _train_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(torch.nn.Linear(2, 2), None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(torch.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--script", "asymmetric_shared_ce", "--save_dir", str(tmp_path)])


@pytest.mark.parametrize("option", ["ACCUM_ITER", "TRAIN_SCORE", "FSDP", "REMAT", "AMP", "VAL"])
def test_unported_training_options_raise(option, tmp_path, capsys):
    """FSDP shards over a process group, so without one it raises and says
    how to form one (tests/test_torch_port_fsdp.py trains it over two);
    REMAT builds the flagship with its remat path. AMP is accepted: the Trainer computes
    in bf16 by default, as the JAX one does, and AMP changes nothing.
    TRAIN_SCORE is ported: on the online script it trains the score branch
    alone, and on a script without the branch it raises.
    ACCUM_ITER and the val split are ported: ACCUM_ITER 2 reaches the
    optimizer, and a val split that
    cannot be built here (RGBT234, whose path is not configured) is disabled with the JAX
    package's printed line, while a SyntheticRGBT one builds."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg(small=True)
    make = lambda c: Trainer("asymmetric_shared_ce", c, save_dir=str(tmp_path),  # noqa: E731
                             device="cpu", spec_overrides=TINY)
    if option == "ACCUM_ITER":
        cfg.TRAIN.ACCUM_ITER = 2
        assert make(cfg).optimizer.accum == 2
    elif option == "VAL":
        cfg.DATA.VAL.DATASETS_NAME = ["RGBT234"]
        assert make(cfg).val_loader is None
        assert "[build_dataloaders] val loader disabled" in capsys.readouterr().out
        cfg.DATA.VAL.DATASETS_NAME = ["SyntheticRGBT"]
        tr = make(cfg)
        assert tr.val_loader.name == "val" and tr.val_loader.epoch_interval == 10
    elif option == "TRAIN_SCORE":
        cfg.TRAIN.TRAIN_SCORE = True
        with pytest.raises(ValueError, match="score branch"):
            make(cfg)
        tr = Trainer("asymmetric_shared_online", cfg, save_dir=str(tmp_path), device="cpu",
                     spec_overrides=TINY)
        assert tr._step.train_score and list(tr.optimizer.groups) == ["main"]
        assert all(p_.startswith("score_branch.") for p_, p in tr.model.named_parameters()
                   if any(p is q for q in tr.optimizer.groups["main"]))
    elif option == "AMP":
        cfg.TRAIN.AMP = True
        tr = make(cfg)
        assert tr.dtype == torch.bfloat16
        assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    elif option == "FSDP":
        cfg.TRAIN.FSDP = True
        with pytest.raises(ValueError, match="torchrun or with --coordinator"):
            make(cfg)
    else:
        cfg.TRAIN.REMAT = True
        tr = make(cfg)
        assert tr.model.backbone.remat and tr._step.dp is None


def test_warm_start_paths_raise(tmp_path):
    """A configured warm-start path that does not exist raises
    FileNotFoundError, as in the JAX package, before anything is built."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg()
    cfg.MODEL.RGBT_PRETRAINED_PATH = str(tmp_path / "missing.pth.tar")
    with pytest.raises(FileNotFoundError, match="RGBT_PRETRAINED_PATH"):
        Trainer("asymmetric_shared_ce", cfg, save_dir=str(tmp_path), device="cpu")
    cfg = _train_cfg()
    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.MODEL.BACKBONE.PRETRAINED_PATH = str(tmp_path / "missing_mae.pth")
    with pytest.raises(FileNotFoundError, match="BACKBONE.PRETRAINED_PATH"):
        Trainer("asymmetric_shared_ce", cfg, save_dir=str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)


def test_checkpoints_and_fail_safe_raise(tmp_path):
    """Checkpoints and the fail-safe restart are ported: save, resume and
    load_latest work, and an epoch that raises is retried from the latest
    checkpoint."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg(small=True)
    make = lambda: Trainer("asymmetric_shared_ce", cfg, save_dir=str(tmp_path),  # noqa: E731
                           device="cpu", spec_overrides=TINY, dtype=torch.float32)
    tr = make()
    tr.epoch = 3
    path = tr.save_checkpoint()
    assert path.endswith("MixFormerRGBT_ep0003.pth.tar") and os.path.isfile(path)
    tr2 = make()
    assert tr2.load_checkpoint() and tr2.epoch == 3
    tr2.train(max_epochs=4, load_latest=True)
    assert tr2.epoch == 4
    calls = []
    orig = tr2.cycle_dataset

    def flaky(loader=None, train=True):
        calls.append(train)
        if len(calls) == 1:
            raise RuntimeError("injected failure")
        return orig(loader, train)

    tr2.cycle_dataset = flaky
    tr2.train(max_epochs=5, fail_safe=True)
    assert tr2.epoch == 5 and len(calls) == 2
    with pytest.raises(RuntimeError, match="injected"):
        calls.clear()
        tr2.train(max_epochs=6, fail_safe=False)
