"""The port stands alone: it imports neither JAX, flax, the JAX package nor
cv2 (absent on the machine with the GPU), and its entry points run on the
GPU or raise — they never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "multi_modal_tracking_torch")
FORBIDDEN = ("jax", "flax", "multi_modal_tracking_tpu", "cv2")


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


def test_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import multi_modal_tracking_torch.eval.evaltracker as e\n"
            "import multi_modal_tracking_torch.tracking.tracker, "
            "multi_modal_tracking_torch.utils.convert\n"
            "import multi_modal_tracking_torch.train.trainer\n"
            "from multi_modal_tracking_torch.eval.evaltracker import create_tracker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multi_modal_tracking_tpu', 'cv2')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.models.build import build_model
    from multi_modal_tracking_torch.tracking.tracker import RGBTCachedTracker, RGBTTracker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_tracker(params, "LasHeR")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("asymmetric_shared_ce", params.cfg)
    model = torch.nn.Linear(2, 2)
    for cls in (RGBTTracker, RGBTCachedTracker):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(model)


def test_unported_options_raise():
    from multi_modal_tracking_torch.eval.evaltracker import create_tracker
    from multi_modal_tracking_torch.eval.params import get_parameters
    from multi_modal_tracking_torch.models.build import build_model

    params = get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer")
    with pytest.raises(NotImplementedError, match="dtype"):
        build_model("asymmetric_shared_ce", params.cfg, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="score branch"):
        build_model("asymmetric_shared_online", params.cfg, device="cpu")
    params.checkpoint = "model.pth"
    with pytest.raises(NotImplementedError, match="checkpoint"):
        create_tracker(params, device="cpu")
    from multi_modal_tracking_torch.models.asymmetric_shared import AsymSharedViT
    with pytest.raises(NotImplementedError, match="CE_TEMPLATE_RANGE"):
        AsymSharedViT(ce_template_range="CTR_REC")


def _train_cfg():
    from multi_modal_tracking_torch.config import get_default_config
    cfg = get_default_config("asymmetric_shared_ce")
    cfg.update_from_file(os.path.join(ROOT, "experiments", "asymmetric_shared_ce",
                                      "attention_lasher_newfusion_2layer.yaml"))
    cfg.DATA.TRAIN.DATASETS_NAME = ["SyntheticRGBT"]
    cfg.DATA.VAL.DATASETS_NAME = []
    cfg.MODEL.BACKBONE.PRETRAINED = False
    cfg.MODEL.RGBT_PRETRAINED_PATH = ""
    cfg.TRAIN.NUM_WORKER = 0
    return cfg


def test_training_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from multi_modal_tracking_torch.train.train_step import make_train_step
    from multi_modal_tracking_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer("asymmetric_shared_ce", _train_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(torch.nn.Linear(2, 2), None)


@pytest.mark.parametrize("option", ["ACCUM_ITER", "TRAIN_SCORE", "FSDP", "REMAT", "AMP", "VAL"])
def test_unported_training_options_raise(option):
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg()
    if option == "VAL":
        cfg.DATA.VAL.DATASETS_NAME = ["RGBT234"]
    else:
        cfg.TRAIN[option] = 2 if option == "ACCUM_ITER" else True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer("asymmetric_shared_ce", cfg, device="cpu")


def test_warm_start_paths_raise(tmp_path):
    """A configured warm start raises: FileNotFoundError for a missing file,
    as the JAX package does, else NotImplementedError (checkpoint loading
    is not ported)."""
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg()
    cfg.MODEL.RGBT_PRETRAINED_PATH = str(tmp_path / "missing.pth.tar")
    with pytest.raises(FileNotFoundError, match="RGBT_PRETRAINED_PATH"):
        Trainer("asymmetric_shared_ce", cfg, device="cpu")
    present = tmp_path / "mae.pth"
    present.write_bytes(b"")
    cfg = _train_cfg()
    cfg.MODEL.BACKBONE.PRETRAINED = True
    cfg.MODEL.BACKBONE.PRETRAINED_PATH = str(present)
    with pytest.raises(NotImplementedError, match="item 10"):
        Trainer("asymmetric_shared_ce", cfg, device="cpu")


def test_checkpoints_and_fail_safe_raise():
    from multi_modal_tracking_torch.train.trainer import Trainer
    cfg = _train_cfg()
    cfg.DATA.SEARCH.SIZE, cfg.DATA.TEMPLATE.SIZE = 64, 32
    tr = Trainer("asymmetric_shared_ce", cfg, device="cpu",
                 spec_overrides=dict(embed_dim=32, depth=1, num_heads=2, head_dim=32,
                                     fusion_layers=1, ce_loc=None, ce_keep_ratio=None))
    for call in (tr.save_checkpoint, tr.load_checkpoint, lambda: tr.train(fail_safe=True),
                 lambda: tr.train(load_latest=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
