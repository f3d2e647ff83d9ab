"""The port stands alone: it imports neither JAX, flax nor the JAX package,
and its entry points run on the GPU or raise — they never fall back to the
CPU on their own."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "multi_modal_tracking_torch")
FORBIDDEN = ("jax", "flax", "multi_modal_tracking_tpu")


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
            "from multi_modal_tracking_torch.eval.evaltracker import create_tracker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'multi_modal_tracking_tpu')]\n"
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
