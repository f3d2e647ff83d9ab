"""The port's FSDP (TRAIN.FSDP: FSDP2 with the JAX package's placement
rule, parallel/mesh.py) and its sharded checkpoints on the CPU, over two
gloo processes (tests/torch_port_parallel_worker.py, one spawn) at the
tiny flagship geometry of tests/test_torch_port_parallel.py.

  * the placement rule equals the JAX package's `fsdp_shardings` on every
    parameter of the tiny flagship (tests/test_fsdp.py:17);
  * the FSDP step equals the DP step with tests/test_fsdp.py:36's
    tolerances (loss 1e-4, grad_norm 1e-3 rel, parameters 5e-2), and at
    this geometry also the loss metrics at 1e-6 and the parameters at 1e-5
    (a near-zero gradient element's AdamW step, as in
    tests/test_torch_port_parallel.py; the unclipped grad_norm of this
    model moves by 1e-6 of itself with the order of its sums);
  * each rank holds at most half of DP's parameter and moment bytes plus
    the replicated leaves;
  * the Trainer under FSDP trains an epoch, writes a sharded checkpoint
    (a `.dcp` directory, every rank its own shards) and resumes exactly on
    both ranks; the checkpoint loads into a one-process Trainer
    (`reshard=True`; without it the change of world size raises) and into
    `load_variables` for tracking.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.parallel.mesh import create_mesh, fsdp_shardings

from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models.build import init_random
from multi_modal_tracking_torch.parallel.mesh import shard_dim
from multi_modal_tracking_torch.train.trainer import Trainer
from multi_modal_tracking_torch.utils import checkpoint as port_ckpt
from tests.test_torch_port_model import GEOM, S_SZ, T_SZ
from tests.test_torch_port_parallel import SCRIPT, run_cfg, spawn, tiny_inputs
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MIN_SIZE = 64          # tests/test_fsdp.py's, so that most leaves are sharded


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fsdp")
    model = init_random(port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM)), 0)
    inp = tiny_inputs(state=model.state_dict(), min_size=MIN_SIZE)[-1]
    torch.save(inp, workdir / "inputs.pt")
    return dict(ranks=spawn("fsdp", workdir), inp=inp)


def test_placement_rule_matches_jax_fsdp_shardings():
    jmodel = jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**GEOM))
    tz = jnp.zeros((2, T_SZ, T_SZ, 3), jnp.float32)
    sz = jnp.zeros((2, S_SZ, S_SZ, 3), jnp.float32)
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), tz, tz, sz)
    specs = fsdp_shardings(variables["params"], create_mesh(8))
    leaves = jax.tree_util.tree_leaves_with_path(variables["params"])
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: hasattr(x, "spec"))
    named = {}
    for (path, leaf), sh in zip(leaves, spec_leaves):
        dims = [d for d, a in enumerate(sh.spec) if a == "data"]
        named[path] = (leaf.shape, dims[0] if dims else None)
    n_sharded = 0
    for shape, want in named.values():
        assert shard_dim(shape, 8) == want, (shape, want)
        n_sharded += want is not None
    assert n_sharded > 10
    # and the port's parameters of the same model shard as many leaves
    port = port_as.MixFormerRGBT(port_as.RGBTSpec(**GEOM))
    assert sum(shard_dim(p.shape, 8) is not None for p in port.parameters()) == n_sharded


def test_fsdp_step_matches_dp(fsdp):
    for r in fsdp["ranks"]:
        dp, fs = r["step"]["dp"], r["step"]["fsdp"]
        assert fs["n_sharded"] > 10
        np.testing.assert_allclose(fs["metrics"]["Loss/total"], dp["metrics"]["Loss/total"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(fs["metrics"]["grad_norm"], dp["metrics"]["grad_norm"],
                                   rtol=1e-3)
        err = max(float((fs["params"][k] - v).abs().max()) for k, v in dp["params"].items())
        assert err < 5e-2, err
        for k in ("Loss/total", "Loss/ciou", "Loss/l1", "IoU"):
            np.testing.assert_allclose(fs["metrics"][k], dp["metrics"][k], atol=1e-6,
                                       rtol=1e-6, err_msg=k)
        assert err < 1e-5, err


def test_fsdp_holds_half_the_state_bytes(fsdp):
    for r in fsdp["ranks"]:
        dp, fs = r["step"]["dp"], r["step"]["fsdp"]
        dp_params, dp_moments = dp["bytes"]
        fs_params, fs_moments = fs["bytes"]
        rep = fs["replicated_bytes"]
        assert fs_params <= 0.5 * dp_params + rep
        assert fs_moments <= 0.5 * dp_moments + 2 * rep
        assert fs_params + fs_moments < 0.6 * (dp_params + dp_moments)


def test_sharded_checkpoint_resumes_exactly(fsdp):
    for r in fsdp["ranks"]:
        res = r["resume"]
        assert (res["epoch"], res["count"]) == ((1, 1), (2, 2))     # 2 steps an epoch
        assert res["model"] and res["moments"] and res["generator"], res
    path = fsdp["ranks"][0]["resume"]["path"]
    ckpt = port_ckpt.latest_checkpoint_sharded(path, "MixFormerRGBT")
    assert ckpt.endswith("MixFormerRGBT_ep0001.dcp") and port_ckpt.is_sharded_checkpoint(ckpt)
    # every rank wrote its own shard file
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".distcp")) == \
        ["__0_0.distcp", "__1_0.distcp"]


def test_sharded_checkpoint_loads_into_one_process(fsdp, tmp_path, monkeypatch):
    # metrics.jsonl without TensorBoard, whose first import costs seconds
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rank0 = fsdp["ranks"][0]
    ckpt = port_ckpt.latest_checkpoint_sharded(rank0["resume"]["path"], "MixFormerRGBT")
    tr = Trainer(SCRIPT, run_cfg(), save_dir=str(tmp_path), device="cpu", seed=0,
                 spec_overrides=fsdp["inp"]["tiny"], dtype=torch.float32)
    with pytest.raises(ValueError, match="written by 2 processes, this run has 1"):
        tr.load_checkpoint(ckpt)
    assert tr.load_checkpoint(ckpt, reshard=True) and tr.epoch == 1
    assert tr.optimizer.count == 2
    state = tr.model.state_dict()
    for k, v in rank0["full_state"].items():
        assert torch.equal(state[k], v), k
    opt = tr.optimizer
    moments = [t for g in opt.groups for mv in zip(opt.mu[g], opt.nu[g]) for t in mv]
    assert len(moments) == len(rank0["full_moments"])
    assert all(torch.equal(a, b) for a, b in zip(moments, rank0["full_moments"].values()))
    # and the network into a model for tracking, strictly
    model = port_as.MixFormerRGBT(tr.model.spec).eval()
    report = port_ckpt.load_variables(ckpt, model, strict=True)
    assert report["loaded"] == report["total"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, rank0["full_state"][k]), k
