"""The port's tensor parallelism (multi_modal_tracking_torch.parallel.tensor,
`create_mesh_2d` and `tensor_parallel_dims` of parallel/mesh.py) on the
CPU: four gloo processes as a 2 x 2 data x model group
(tests/torch_port_parallel_worker.py, one spawn) at the tiny flagship
geometry of tests/test_torch_port_model.py (embed 64, 4 heads, CE at
blocks 1/3, LNSpecific fusion, CORNER_UP head with trainable BatchNorm),
drop path and dropout 0, global batch 2, CE at keep 0.7, one torch thread:

  * the step against the JAX package's `make_train_step(mesh=
    create_mesh_2d(2, 2), state_shardings=param_shardings(...))` on the
    virtual CPU devices, same weights and global batch: loss 1e-5 rel
    (tests/test_tensor_parallel.py holds JAX's own TP step to 1e-4),
    grad_norm 1e-3 rel;
  * the step against the port's one-process step on the whole batch,
    within tests/test_torch_port_parallel.py's data-parallel bounds:
    metrics and the gathered gradients and BN statistics at 1e-6, the
    gathered parameters at 1e-6 + lr |dg| / eps per element;
  * the replicated parameters and the BN statistics are the same bits on
    the two ranks of each model group, and the shards differ; with drop
    path and dropout on, masks drawn by Megatron's rule keep them so;
  * the placement rule: the parameters the port shards, and each one's
    dimension, are the JAX leaves `param_shardings(create_mesh_2d(2, 2))`
    shards, matched through the converter's key map, on the flagship at
    full width (shapes only: `jax.eval_shape`, the port on the meta
    device); `shard_state_dict` / `gather_state_dict` round trips, the
    qkv rows cut per head;
  * what raises: a world that is not n_data * n_model, a model outside
    models/build.py SCRIPTS (Alpha-Refine), a graphed CUDA step over gloo,
    the attention maps under TP.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.parallel.mesh import (create_mesh_2d as jax_mesh_2d,
                                                    param_shardings, shard_batch)
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.layers import skip_default_init
from multi_modal_tracking_torch.parallel import mesh as port_mesh
from multi_modal_tracking_torch.parallel import tensor as port_tp
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.utils.convert import _port_leaves
from tests.test_torch_port_model import GEOM
from tests.test_torch_port_parallel import (RECIPE, SCRIPT, _Deterministic, finish, start,
                                            tiny_inputs)
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KEEP = 0.7
WORLD = 4


def one_process_step(inp, keep):
    """The port's step on the whole global batch in this process."""
    model = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM, drop_path_rate=0.0,
                                                   fusion_dropout=0.0))
    model.load_state_dict(inp["state"], strict=True)
    opt = port_opt.make_optimizer(copy.deepcopy(inp["cfg"]), model, steps_per_epoch=4)
    step = port_ts.make_train_step(model, opt, device="cpu")
    t, ot, s, gt = inp["batches"][0]
    m = step({"t": t, "ot": ot, "s": s, "gt_xywh": gt}, ce_keep_rate=keep)
    names = [n for n, _ in model.named_parameters()]
    return dict(metrics={k: float(v) for k, v in m.items()},
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                buffers={k: b.clone() for k, b in model.state_dict().items() if k not in names},
                grads=dict(zip(names, opt.grads)))


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The four ranks' results; the JAX 2 x 2 step runs while they do."""
    workdir = tmp_path_factory.mktemp("tp")
    jmodel, variables, jcfg, batches, inp = tiny_inputs(keep=KEEP)
    torch.save(inp, workdir / "inputs.pt")
    procs = start("tp", workdir, WORLD)
    try:
        tx = jax_opt.make_optimizer(jcfg, variables["params"], steps_per_epoch=4)
        mesh = jax_mesh_2d(2, 2)
        state = jax_ts.TrainState.create(variables, tx)
        shardings = param_shardings(state, mesh)
        state = jax.device_put(state, shardings)
        step = jax_ts.make_train_step(_Deterministic(jmodel), tx, mesh=mesh,
                                      state_shardings=shardings)
        t, ot, s, gt = batches[0]
        B = gt.shape[0]
        batch = dict(template_v=t[:B], template_i=t[B:], online_template_v=ot[:B],
                     online_template_i=ot[B:], search_v=s[:B], search_i=s[B:], gt_xywh=gt)
        _, metrics = step(state, shard_batch(batch, mesh), jax.random.PRNGKey(0),
                          ce_keep_rate=KEEP)
        jax_metrics = {k: float(v) for k, v in metrics.items()}
    finally:
        ranks = finish("tp", procs, workdir)
    return dict(ranks=ranks, inp=inp, jax_metrics=jax_metrics)


def test_tp_step_matches_jax_2x2_step(tp):
    want = tp["jax_metrics"]
    for r in tp["ranks"]:
        for k in want:
            np.testing.assert_allclose(r["metrics"][k], want[k],
                                       rtol=1e-3 if k == "grad_norm" else 1e-5, err_msg=k)


def test_tp_step_matches_one_process_step(tp):
    want = one_process_step(tp["inp"], KEEP)
    cfg = tp["inp"]["cfg"]
    lr = max(cfg.TRAIN.LR * m for m in (1.0, cfg.TRAIN.BACKBONE_MULTIPLIER))
    for r in tp["ranks"]:
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], w, atol=1e-6, rtol=1e-6, err_msg=k)
        assert r["grads"].keys() == want["grads"].keys()
        for k, w in want["grads"].items():
            np.testing.assert_allclose(r["grads"][k].numpy(), w.numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)
        for k, w in want["params"].items():
            tol = 1e-6 + lr * (r["grads"][k] - want["grads"][k]).abs() / port_opt.EPS
            assert bool(((r["params"][k] - w).abs() <= tol).all()), k
        for k, w in want["buffers"].items():
            np.testing.assert_allclose(r["local"][k].double().numpy(), w.double().numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)


def test_tp_ranks_hold_their_shards_and_equal_replicas(tp):
    ranks = tp["ranks"]
    assert [r["grid"] for r in ranks] == [(0, 0, 2, 2), (0, 1, 2, 2), (1, 0, 2, 2),
                                          (1, 1, 2, 2)]
    assert all("needs 3 processes" in r["wrong_world"] for r in ranks)
    dims = ranks[0]["dims"]
    assert ranks[0]["heads"] == GEOM["num_heads"] // 2
    for a, b in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        for k, v in a["local"].items():
            if k in dims:
                assert not torch.equal(v, b["local"][k]), k
            else:
                assert torch.equal(v, b["local"][k]), k
    # the data ranks hold the same model after the step
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[2]["params"][k]), k
    assert any(k.endswith("running_var") for k in ranks[0]["local"])


def test_tp_random_masks_follow_megatrons_rule(tp):
    """Drop path and dropout at 0.1: the masks on replicated activations
    come from a generator seeded by data rank, so the ranks of a model group
    keep the same replicated state after a step; the fusion's dropout2 (on
    the sharded FFN hidden) draws from one seeded by the global rank."""
    ranks = tp["ranks"]
    assert [r["seeds"] for r in ranks] == [(8, 2725), (8, 2726), (9, 2727), (9, 2728)]
    assert ranks[0]["sharded_masks"] == [f"fusion_vi.fusion_attention.encoder.layers.{i}.dropout2"
                                         for i in range(GEOM["fusion_layers"])]
    dims = ranks[0]["dims"]
    for a, b in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        assert a["dropped_metrics"] == b["dropped_metrics"]
        for k, v in a["dropped_local"].items():
            if k not in dims:
                assert torch.equal(v, b["dropped_local"][k]), k
    # the masks moved the step: its loss is not the one without them
    assert ranks[0]["dropped_metrics"]["Loss/total"] != ranks[0]["metrics"]["Loss/total"]


def test_tp_dims_match_jax_param_shardings_at_full_width():
    cfg = get_default_config(SCRIPT)
    cfg.update_from_file(RECIPE)
    with skip_default_init():
        model = port_as.build_mixformer_rgbt(cfg)
    model = model.to("meta")
    got = port_mesh.tensor_parallel_dims(model, 2)

    jmodel = jax_as.build_mixformer_rgbt(cfg_jax())
    t = jax.ShapeDtypeStruct((2, 128, 128, 3), jnp.float32)
    s = jax.ShapeDtypeStruct((2, 288, 288, 3), jnp.float32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), t, t, s)
    specs = param_shardings(shapes["params"], jax_mesh_2d(2, 2))
    zeros = jax.tree.map(lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape),
                         {"params": shapes["params"]})
    spec_of = {tuple(getattr(k, "key", str(k)) for k in path): sh.spec
               for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]}
    want = {}
    for _, path, key, arr in _port_leaves(zeros):
        spec = tuple(spec_of[path])
        if "model" not in spec:
            continue
        # the converter's layouts: a Dense kernel transposed, a conv HWIO -> OIHW
        perm = {2: (1, 0), 4: (3, 2, 0, 1)}.get(arr.ndim, tuple(range(arr.ndim)))
        want[key] = perm.index(spec.index("model"))
    assert got == want
    # per block qkv (weight, bias), proj, fc1 (weight, bias), fc2; per fusion
    # layer linear1 (weight, bias), linear2, output_proj
    assert len(got) == 6 * 12 + 4 * 2
    assert set(got.values()) == {0, 1}
    assert "backbone.patch_embed.proj.weight" not in got        # 3 input channels
    assert port_mesh.tensor_parallel_dims(model, 3)["backbone.patch_embed.proj.weight"] == 1


def cfg_jax():
    from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
    c = jax_default_config(SCRIPT)
    c.update_from_file(RECIPE)
    return c


def test_shard_and_gather_state_dict_round_trip():
    """Per-head qkv rows: rank r holds rows [r*C/n, (r+1)*C/n) of each of q,
    k and v; gathering over one rank's group of one is the identity."""
    C = 8
    w = torch.arange(3 * C * 2, dtype=torch.float32).reshape(3 * C, 2)
    b = torch.arange(3 * C, dtype=torch.float32)
    state = {"blk.attn.qkv.weight": w, "blk.attn.qkv.bias": b,
             "blk.mlp.fc2.weight": torch.arange(12.0).reshape(2, 6), "norm.weight": torch.ones(3)}
    dims = {"blk.attn.qkv.weight": 0, "blk.attn.qkv.bias": 0, "blk.mlp.fc2.weight": 1}
    parts = [port_tp.shard_state_dict(state, dims, r, 2) for r in range(2)]
    assert torch.equal(parts[1]["blk.attn.qkv.bias"],
                       torch.cat([b[4:8], b[12:16], b[20:24]]))
    assert torch.equal(parts[0]["blk.mlp.fc2.weight"], state["blk.mlp.fc2.weight"][:, :3])
    assert parts[0]["norm.weight"] is state["norm.weight"]
    # the inverse, by the same concatenation gather_state_dict makes
    for k, d in dims.items():
        if "qkv" in k:
            rest = tuple(state[k].shape[1:])
            whole = torch.cat([p[k].reshape((3, -1) + rest) for p in parts], 1).reshape(
                (-1,) + rest)
        else:
            whole = torch.cat([p[k] for p in parts], d)
        assert torch.equal(whole, state[k]), k


def test_tp_raises_outside_its_scope(monkeypatch):
    class Group:
        world, rank, backend, capturable = 2, 0, "gloo", False

    def Tp(n_model=2):
        model = Group()
        model.world = n_model
        return port_mesh.TensorParallel(1, n_model, Group(), model)
    # a model outside models/build.py SCRIPTS: Alpha-Refine has no JAX TP path
    from multi_modal_tracking_torch.models.alpha_refine import build_alpha_refine
    m, _ = build_alpha_refine(input_sz=64, output_sz=64, device="cpu")
    with pytest.raises(NotImplementedError, match="not AlphaRefineNet"):
        port_tp.shard_tensor_parallel_(m, Tp())
    # a model whose heads do not split over the group
    m = port_as.MixFormerRGBT(port_as.RGBTSpec(**dict(GEOM, num_heads=4)))
    with pytest.raises(ValueError, match="cannot be split"):
        port_tp.shard_tensor_parallel_(m, Tp(8))
    # the attention maps need every head
    m = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM))
    for blk in m.backbone.blocks:
        blk.attn.model_group = Group()
    z = torch.zeros
    with pytest.raises(NotImplementedError, match="return_attn_maps"):
        m.backbone(z(2, 112, 112, 3), z(2, 112, 112, 3), z(2, 176, 176, 3),
                   return_attn_maps=True)
    # a graphed CUDA step over gloo
    monkeypatch.setattr(port_ts, "resolve_device", lambda d: torch.device("cuda"))
    m.tp_dims = {}
    opt = type("Opt", (), {"tp": None})()
    opt.tp = tp_ = Tp()
    with pytest.raises(ValueError, match="pass graphs=False"):
        port_ts.make_train_step(m, opt, tp=tp_)
    with pytest.raises(ValueError, match="not both"):
        port_ts.make_train_step(m, opt, tp=tp_, dp=Group())
