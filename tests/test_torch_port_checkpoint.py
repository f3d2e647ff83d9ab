"""The port's checkpoint layer (multi_modal_tracking_torch.utils) against the
JAX package's, on the CPU, at the tiny flagship geometry of
tests/test_torch_port_model.py (width 64, depth 4, CE at 1/3, search 176,
template 112, CORNER_UP, LNSpecific fusion with 2 layers).

  * the pure-Python flax msgpack reader equals flax.serialization's
    `msgpack_restore` exactly (values, dtypes, shapes; bfloat16 by its bits);
  * a JAX .msgpack checkpoint (TrainState in the trainer's envelope) loads
    into the port bit-identical to `from_jax_variables`, and the forward
    then matches JAX within test_torch_port_model.py's ATOL (2e-5 on
    boxes normalised to [0, 1]);
  * strict loads raise or pass alike in both packages on the four cases of
    tests/test_torch_convert.py (partial, mis-shaped, checkpoint-only key,
    exact);
  * reference-format .pth files (a {"net": sd} trainer file strictly and as
    a warm start, a bare MAE backbone dict, a unimodal norm1 net) load to
    the same weights in both packages, exactly;
  * the keep policy of epoch files, checkpoint_epoch, latest_checkpoint and
    get_parameters(model=...) as in the JAX package.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from multi_modal_tracking_tpu.eval.params import get_parameters as jax_get_parameters
from multi_modal_tracking_tpu.train.train_step import TrainState
from multi_modal_tracking_tpu.utils import checkpoint as jax_ckpt

from multi_modal_tracking_torch.eval.params import get_parameters
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.utils import checkpoint as port_ckpt
from multi_modal_tracking_torch.utils import flax_msgpack
from multi_modal_tracking_torch.utils.convert import from_jax_variables
from tests.test_torch_port_model import (ATOL, GEOM, _inputs, _jax_full, _pair, _port_full,
                                         _randomise)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def pair():
    return _pair(GEOM, 21)


def _port_model():
    return port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM)).eval()


# ------------------------------------------------------------------ reader
def _train_state_bytes():
    variables = {"params": {"dense": {"kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
                                      "bias": np.ones(4, np.float32)}},
                 "batch_stats": {"bn": {"mean": np.zeros(4, np.float32),
                                        "var": np.ones(4, np.float32)}}}
    tx = optax.MultiSteps(optax.adamw(1e-3), every_k_schedule=2)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    return serialization.to_bytes({"state": state, "epoch": 3})


_READER_CASES = {
    "train_state": _train_state_bytes,
    "f32": lambda: serialization.to_bytes({"a": np.linspace(-2, 2, 12, dtype=np.float32)}),
    "bf16": lambda: serialization.to_bytes({"a": jnp.asarray([1.5, -3.25, 1e-3, 7e4],
                                                             jnp.bfloat16)}),
    "int32": lambda: serialization.to_bytes({"a": np.arange(-5, 5, dtype=np.int32)}),
    "bool": lambda: serialization.to_bytes({"a": np.array([True, False, True])}),
    "0d": lambda: serialization.to_bytes({"a": np.array(2.5, np.float32), "b": np.int64(-7)}),
    "empty": lambda: serialization.to_bytes({"a": np.zeros((0, 3), np.float32)}),
    "nested": lambda: serialization.msgpack_serialize(
        {"m": {"n": [1, -300, 70000, -2 ** 40, 2 ** 63 - 1, 0.25, None, True, "s" * 40,
                     b"raw", [np.ones((2, 2), np.float32), {"x": "y" * 300}]]},
         "t": [[], {}]}),
}


def _assert_same(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      want.view(np.uint16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("case", sorted(_READER_CASES))
def test_msgpack_reader_equals_flax(case):
    data = _READER_CASES[case]()
    _assert_same(flax_msgpack.restore(data), serialization.msgpack_restore(data))


def test_msgpack_reader_rejects_complex_and_truncated_data():
    data = serialization.to_bytes({"c": np.complex64(1 + 2j)})
    with pytest.raises(ValueError, match="complex|ext"):
        flax_msgpack.restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(data[:-3])


# ----------------------------------------------------------- JAX .msgpack
def test_jax_msgpack_loads_bit_exact_and_forward_matches(pair, tmp_path):
    """A TrainState written by the JAX package's own save_checkpoint (the
    trainer's {"epoch", "state"} envelope; opt_state ignored)."""
    jmodel, variables, _ = pair
    tx = optax.adamw(1e-3)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    path = jax_ckpt.save_checkpoint(str(tmp_path), "MixFormerRGBT", 4,
                                    {"state": jax.device_get(state), "epoch": 4})
    pmodel = _port_model()
    report = port_ckpt.load_variables(path, pmodel, strict=True)
    assert not report["missing"] and not report["unexpected"]
    want = from_jax_variables(variables)
    got = pmodel.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    t, ot, s = _inputs(30)
    np.testing.assert_allclose(_port_full(pmodel, t, ot, s, False),
                               _jax_full(jmodel, variables, t, ot, s, False), atol=ATOL, rtol=0)


def _first_leaf(tree, pred):
    for k, v in tree.items():
        if isinstance(v, dict):
            hit = _first_leaf(v, pred)
            if hit:
                return (k,) + hit
        elif pred(v):
            return (k,)
    return None


def _edit(variables, case):
    """The four checkpoints of tests/test_torch_convert.py on the flagship."""
    out = jax.tree.map(np.asarray, variables)
    path = _first_leaf(out["params"]["box_head"], lambda v: np.ndim(v) == 1)
    node = out["params"]["box_head"]
    for k in path[:-1]:
        node = node[k]
    if case == "partial":
        del node[path[-1]]
    elif case == "mis_shaped":
        node[path[-1]] = np.zeros(node[path[-1]].shape[0] + 1, np.float32)
    elif case == "checkpoint_only_key":
        out["params"]["score_head"] = np.zeros(4, np.float32)
    return out


@pytest.mark.parametrize("case", ["partial", "mis_shaped", "checkpoint_only_key", "exact"])
def test_strict_cases_match_jax(pair, tmp_path, case):
    jmodel, variables, _ = pair
    src = _edit(_randomise(variables, 22), case)
    path = str(tmp_path / f"{case}.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(src))
    outcomes = []
    for load in (lambda: jax_ckpt.load_variables(path, variables, strict=True),
                 lambda: port_ckpt.load_variables(path, _port_model(), strict=True)):
        try:
            load()
            outcomes.append("pass")
        except ValueError as e:
            assert "strict" in str(e)
            outcomes.append("raise")
    assert outcomes == (["pass", "pass"] if case == "exact" else ["raise", "raise"])
    if case == "partial":      # the warm-start semantics: the rest keeps its init
        jax_out = jax_ckpt.load_variables(path, variables, strict=False)
        pmodel = _port_model()
        pmodel.load_state_dict(from_jax_variables(variables), strict=True)
        port_ckpt.load_variables(path, pmodel, strict=False)
        _assert_same_weights(pmodel, jax_out)


# ------------------------------------------------------------------ .pth
def _assert_same_weights(pmodel, jax_variables):
    want = from_jax_variables(jax.tree.map(np.asarray, jax_variables))
    got = pmodel.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _fold(sd):
    """Unimodal form of a port state dict: norm1_v/norm2_v -> norm1/norm2."""
    return {k.replace("norm1_v.", "norm1.").replace("norm2_v.", "norm2."): v for k, v in sd.items()
            if "norm1_i." not in k and "norm2_i." not in k}


def _pth_case(case, sd):
    if case in ("net_strict", "net_warm"):
        return {"net": sd, "epoch": 9}
    bb = {k: v for k, v in _fold(sd).items() if k.startswith("backbone.blocks.")
          or k.startswith("backbone.patch_embed.")}
    g = torch.Generator().manual_seed(0)
    extra = {"pos_embed": torch.randn(1, 5, 64, generator=g), "mask_token": torch.zeros(1, 1, 64)}
    if case == "mae":
        bare = {k[len("backbone."):]: v for k, v in bb.items()}
        return {"model": dict(bare, cls_token=torch.randn(1, 1, 64, generator=g), **extra)}
    head = {k: v for k, v in sd.items() if k.startswith("box_head.")}
    return {"net": dict(bb, **head, **{"backbone." + k: v for k, v in extra.items()})}


@pytest.mark.parametrize("case", ["net_strict", "net_warm", "mae", "unimodal"])
def test_reference_pth_loads_alike(pair, tmp_path, case):
    """Both packages start from the same weights and load the same file:
    every tensor ends equal, loaded or kept at its init. The MAE and
    unimodal files expand the LayerNorms and load non-strictly even when
    strict is asked, as warm starts."""
    _, variables, _ = pair
    sd = from_jax_variables(_randomise(variables, 23))
    path = str(tmp_path / ("mae.pth" if case == "mae" else f"{case}.pth.tar"))
    torch.save(_pth_case(case, sd), path)
    strict = case != "net_warm"
    jax_out = jax_ckpt.load_variables(path, variables, strict=strict)
    pmodel = _port_model()
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    report = port_ckpt.load_variables(path, pmodel, strict=strict)
    _assert_same_weights(pmodel, jax_out)
    if case in ("mae", "unimodal"):
        blk = "backbone.blocks.2.norm2_i.weight"
        assert torch.equal(pmodel.state_dict()[blk], sd[blk.replace("_i.", "_v.")])
        assert report["missing"] and all(not k.startswith("backbone.") for k in report["missing"])
        assert report["unexpected"] == (["backbone.cls_token"] if case == "mae" else [])
    else:
        assert not report["missing"] and not report["unexpected"]


def _write_marker(path):
    with open(path, "w") as f:
        f.write("pickled code ran")
    return {"written": path}


class _Settings:
    """A trainer-settings object whose unpickling runs code (writes a file)."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (_write_marker, (self.marker,))


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "warm"])
def test_reference_pth_with_objects_loads_without_running_code(pair, tmp_path, strict):
    """A reference trainer file that pickles an object beside the weights:
    the JAX package's unrestricted load runs its code (the marker file
    appears) and keeps the tensors; the port loads the same weights and runs
    none of it (the marker stays absent)."""
    _, variables, _ = pair
    sd = from_jax_variables(_randomise(variables, 24))
    marker = tmp_path / "marker.txt"
    path = str(tmp_path / "MixFormerRGBT_ep0003.pth.tar")
    torch.save({"net": sd if strict else {k: v for k, v in sd.items() if "box_head" not in k},
                "settings": _Settings(str(marker)), "stats": {"loss": 0.5, "epoch": 3}}, path)
    jax_out = jax_ckpt.load_variables(path, variables, strict=strict)
    assert marker.exists()           # the payload is live under an unrestricted load
    marker.unlink()
    pmodel = _port_model()
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    report = port_ckpt.load_variables(path, pmodel, strict=strict)
    assert not marker.exists()
    _assert_same_weights(pmodel, jax_out)
    assert not report["unexpected"] and bool(report["missing"]) is not strict


# -------------------------------------------------------- files and names
@pytest.mark.parametrize("keep", [(10, 5), (3, 4)], ids=["default", "last3_every4"])
def test_keep_policy_matches_jax(tmp_path, keep):
    keep_last, keep_every = keep
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    for ep in range(1, 13):
        port_ckpt.save_checkpoint(str(pdir), "Net", ep, {"epoch": ep}, keep_last, keep_every)
        jax_ckpt.save_checkpoint(str(jdir), "Net", ep, {"epoch": np.int32(ep)}, keep_last,
                                 keep_every)
    got = sorted(port_ckpt.checkpoint_epoch(p) for p in os.listdir(pdir))
    want = sorted(jax_ckpt.checkpoint_epoch(p) for p in os.listdir(jdir))
    assert got == want and got[-1] == 12
    assert all(p.endswith(".pth.tar") for p in os.listdir(pdir))
    assert port_ckpt.latest_checkpoint(str(pdir), "Net").endswith("Net_ep0012.pth.tar")
    assert port_ckpt.latest_checkpoint(str(tmp_path / "none"), "Net") is None
    assert port_ckpt.load_checkpoint(os.path.join(pdir, "Net_ep0012.pth.tar")) == {"epoch": 12}


def test_checkpoint_epoch_names():
    """The JAX package's rule on its own suffix (.msgpack)."""
    for p in ("a/Net_ep0007.pth.tar", "Net_ep0123.pth.tar", "Net_final.pth.tar",
              "Net_ep12x.pth.tar"):
        want = jax_ckpt.checkpoint_epoch(p.replace(".pth.tar", ".msgpack"))
        assert port_ckpt.checkpoint_epoch(p) == want
    assert port_ckpt.checkpoint_epoch("Net_ep0001.pth") == -1


@pytest.mark.parametrize("from_train", [False, True], ids=["models_dir", "train_result"])
def test_get_parameters_model_resolves_like_jax(tmp_path, monkeypatch, from_train):
    from multi_modal_tracking_torch.train.admin import create_default_local_file
    local = tmp_path / "local_paths.json"
    monkeypatch.setenv("MMT_LOCAL_PATHS", str(local))
    create_default_local_file(save_dir=str(tmp_path / "out"), path=str(local))
    # tracking_vis.yaml sets TEST.LOAD_FROME_TRAIN_RESULT
    kw = dict(tracking_yaml="tracking_vis" if from_train else "tracking",
              model="MixFormerRGBT_ep0150.pth.tar")
    want = jax_get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer", **kw)
    got = get_parameters("asymmetric_shared_ce", "attention_lasher_newfusion_2layer", **kw)
    assert got.cfg.TEST.LOAD_FROME_TRAIN_RESULT is from_train
    assert got.checkpoint == want.checkpoint
    assert got.checkpoint == os.path.join(str(tmp_path / "out"), *(() if from_train else
                                                                   ("models",)),
                                          "MixFormerRGBT_ep0150.pth.tar")
    explicit = get_parameters("asymmetric_shared_ce", checkpoint="a.pth", model="b")
    assert explicit.checkpoint == "a.pth"
