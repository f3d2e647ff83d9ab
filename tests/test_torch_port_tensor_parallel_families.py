"""The port's tensor parallelism for every family beyond the flagship
(multi_modal_tracking_torch.parallel.tensor, `tensor_parallel_dims` of
parallel/mesh.py) on the CPU.

One spawn of four gloo processes as a 2 x 2 data x model group
(tests/torch_port_parallel_worker.py `case_tp_families`) runs one step of
each family at a tiny geometry, drop path and dropout 0, global batch 2,
one torch thread: the online script's stage 1 (CE at keep 0.7) and stage 2
(TRAIN_SCORE: the eval-mode forward, the score loss, the clip over the
frozen gradients too) at tests/test_torch_port_model.py's flagship
geometry cut to two blocks and the other families' crops; the two-stream, shared-LN and unibackbone RGB-T ViTs of
tests/test_torch_port_vit_rgbt.py; the unimodal ViT, CvT and ConvMAE of
tests/test_torch_port_{unimodal,cvt,convmae}.py, whose widths give CvT
two row-parallel patch convolutions (16 and 32 input channels) and
ConvMAE two (32 and 48) at n_model 2. Meanwhile four helper processes
trace the JAX package's 2 x 2 steps and placements (`jax_jobs`; the
suite's JAX set-up from tests/conftest.py), and this one runs the port's
one-process steps. Checked for each family:

  * the step against the JAX package's `make_train_step(mesh=
    create_mesh_2d(2, 2), state_shardings=param_shardings(...))`
    (`rgbt=False` for the unimodal families, `train_score=True` for stage
    2), same weights and global batch: loss 1e-5 rel, grad_norm 1e-3 rel,
    the other metrics 1e-5 rel + 2e-6 (an IoU near zero);
  * the step against the port's one-process step on the whole batch,
    within tests/test_torch_port_parallel.py's data-parallel bounds:
    metrics and the gathered gradients and BN statistics at 1e-6, the
    gathered parameters at 1e-6 + lr |dg| / eps per element; grad_norm
    at 1e-5 rel. The row-parallel sums move the two-stream model's boxes
    by 5e-7 and, through CIoU on the degenerate boxes of random weights,
    its unclipped gradient by 3.5e-6 of its norm (58), where the data
    split alone moves it by 2e-7 and the JAX step is 1.5e-5 away;
  * the replicated parameters and BN statistics are the same bits on the
    two ranks of each model group, and the shards differ;
  * `shard_state_dict` / `gather_state_dict` round trips: the rank's cut
    model holds `shard_state_dict` of the whole state, and gathering it
    gives the whole state back, bit for bit;
  * `RowParallelConv2d` against `conv2d` on the whole input (CvT's second
    stage's embedding, `stage1`, at the template's and the search's
    sizes; ConvMAE's `patch_embed2`): output, input and weight gradients
    within 1e-6 of the largest magnitude of each; the steps of CvT and
    ConvMAE ran row-parallel convolutions.
And the placement rule: for one recipe of each of the 11
scripts beyond the flagship's, at full width (shapes only: `jax.eval_shape`,
the port on the meta device), the parameters the port shards and each
one's dimension equal the JAX leaves `param_shardings(create_mesh_2d(2,
n))` shards, matched through the converter's key map, at n_model 2, 3 and
4 (the rule on the port's own module names would shard ConvMAE's conv
FFN), and the model cuts at each n_model, a row-parallel convolution
included; where the heads do not split (ViT-L's and ConvMAE-L's 16 at
n_model 3) the cut raises ValueError.
"""
import copy
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_tracking_tpu.config import get_default_config as jax_default_config
from multi_modal_tracking_tpu.models import asymmetric_shared as jax_as
from multi_modal_tracking_tpu.models import convmae as jax_cm
from multi_modal_tracking_tpu.models import cvt as jax_cvt
from multi_modal_tracking_tpu.models import mixformer as jax_mf
from multi_modal_tracking_tpu.models import vit_rgbt as jax_vr
from multi_modal_tracking_tpu.models.build import build_model as jax_build_model
from multi_modal_tracking_tpu.parallel.mesh import (create_mesh_2d as jax_mesh_2d,
                                                    param_shardings, shard_batch)
from multi_modal_tracking_tpu.train import optimizer as jax_opt
from multi_modal_tracking_tpu.train import train_step as jax_ts

from multi_modal_tracking_torch.config import get_default_config
from multi_modal_tracking_torch.models import asymmetric_shared as port_as
from multi_modal_tracking_torch.models import build as port_build
from multi_modal_tracking_torch.models import convmae as port_cm
from multi_modal_tracking_torch.models import cvt as port_cvt
from multi_modal_tracking_torch.models import mixformer as port_mf
from multi_modal_tracking_torch.models import vit_rgbt as port_vr
from multi_modal_tracking_torch.models.layers import skip_default_init
from multi_modal_tracking_torch.parallel import mesh as port_mesh
from multi_modal_tracking_torch.parallel import tensor as port_tp
from multi_modal_tracking_torch.train import optimizer as port_opt
from multi_modal_tracking_torch.train import train_step as port_ts
from multi_modal_tracking_torch.utils.convert import _port_leaves, from_jax_variables
from tests.test_torch_port_convmae import TINY as CM_TINY
from tests.test_torch_port_cvt import TINY as CVT_TINY
from tests.test_torch_port_model import GEOM, _randomise
from tests.test_torch_port_parallel import _Deterministic, finish, start
from tests.test_torch_port_unimodal import S_SZ, T_SZ, TINY as VIT_TINY
from tests.test_torch_port_vit_rgbt import SCRIPTS as VR_SCRIPTS, TINY as VR_TINY
from tests.torch_port_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
B = 2
#: the families of the 2 x 2 step: (script, recipe, stage 2, CE keep)
FAMILIES = {
    "online_stage1": ("asymmetric_shared_online", "attention_lasher_newfusion_2layer", False, 0.7),
    "online_stage2": ("asymmetric_shared_online", "attention_lasher_newfusion_2layer", True, None),
    "vit_rgbt": ("mixformer_vit_rgbt", VR_SCRIPTS["mixformer_vit_rgbt"][2], False, None),
    "vit_rgbt_shared": ("mixformer_vit_rgbt_shared", VR_SCRIPTS["mixformer_vit_rgbt_shared"][2],
                        False, None),
    "vit_rgbt_unibackbone": ("mixformer_vit_rgbt_unibackbone",
                             VR_SCRIPTS["mixformer_vit_rgbt_unibackbone"][2], False, None),
    "vit": ("mixformer_vit", "baseline", False, None),
    "cvt": ("mixformer_cvt", "baseline", False, None),
    "convmae": ("mixformer_convmae", "baseline", False, None),
}
#: the families whose steps run row-parallel convolutions at n_model 2
CONV_FAMILIES = ("cvt", "convmae")
#: the online script's tiny geometry: the flagship's of
#: tests/test_torch_port_model.py at the crops of the other families, two
#: blocks, CE at the second
ONLINE_GEOM = dict(GEOM, search_size=S_SZ, template_size=T_SZ, depth=2, ce_loc=(1,),
                   ce_keep_ratio=(0.7,))


def _cfg(get, script, recipe, train_score):
    c = get(script)
    c.update_from_file(os.path.join(ROOT, "experiments", script, f"{recipe}.yaml"))
    c.TRAIN.TRAIN_SCORE = train_score
    return c


def _models(family):
    """(JAX model, the port model without random layers, whether bimodal,
    the crop sizes) of a family at its tiny geometry."""
    off = dict(drop_path_rate=0.0)
    if family.startswith("online"):
        return (jax_as.MixFormerRGBT(spec=jax_as.RGBTSpec(**ONLINE_GEOM), with_score=True),
                port_as.MixFormerRGBT(port_as.RGBTSpec(**ONLINE_GEOM, **off, fusion_dropout=0.0),
                                      with_score=True), True, (T_SZ, S_SZ))
    if family.startswith("vit_rgbt"):
        script = FAMILIES[family][0]
        variant, _, _, fusion, head = VR_SCRIPTS[script]
        geom = dict(VR_TINY, fusion_class=fusion, head_type=head)
        jm = jax_vr.MixFormerViTRGBT(spec=jax_vr.VitRGBTSpec(base=jax_as.RGBTSpec(**geom),
                                                             variant=variant))
        pm = port_vr.MixFormerViTRGBT(port_as.RGBTSpec(**geom, **off, fusion_dropout=0.0),
                                      variant)
        return jm, pm, True, (T_SZ, S_SZ)
    if family == "vit":
        return (jax_mf.MixFormer(spec=jax_mf.ViTSpec(**VIT_TINY, **off)),
                port_mf.MixFormer(port_mf.ViTSpec(**VIT_TINY, **off)), False, (T_SZ, S_SZ))
    if family == "cvt":
        return (jax_cvt.MixFormerCvT(spec=jax_cvt.CvTSpec(**CVT_TINY)),
                port_cvt.MixFormerCvT(port_cvt.CvTSpec(**CVT_TINY)), False, (T_SZ, S_SZ))
    return (jax_cm.MixFormerConvMAE(spec=jax_cm.ConvMAESpec(**CM_TINY)),
            port_cm.MixFormerConvMAE(port_cm.ConvMAESpec(**CM_TINY)), False, (T_SZ, S_SZ))


def _variables(jm, rgbt, sizes, seed):
    """Randomised variables of a JAX model from jax.eval_shape (no init
    compiled): flax's constant inits, then `_randomise`."""
    n = 2 if rgbt else 1
    t = jax.ShapeDtypeStruct((n, sizes[0], sizes[0], 3), jnp.float32)
    s = jax.ShapeDtypeStruct((n, sizes[1], sizes[1], 3), jnp.float32)
    score = getattr(jm, "with_score", False)
    shapes = jax.eval_shape(lambda a, b, c: jm.init(jax.random.PRNGKey(0), a, b, c,
                                                    run_score_head=score), t, t, s)

    def fill(path, x):
        one = str(getattr(path[-1], "key", path[-1])) in ("scale", "var")
        return np.full(x.shape, 1.0 if one else 0.0, np.float32)
    return _randomise(jax.tree_util.tree_map_with_path(fill, shapes), seed)


def _batch(rgbt, sizes, train_score, seed):
    """A global host batch of B samples (`batch_to_model_inputs`' fields)."""
    rng = np.random.default_rng(seed)
    t_sz, s_sz = sizes
    names = (("template_v", "template_i", "online_template_v", "online_template_i"),
             ("search_v", "search_i")) if rgbt else (("template", "online_template"),
                                                     ("search",))
    b = {k: rng.standard_normal((B, t_sz, t_sz, 3)).astype(np.float32) for k in names[0]}
    b.update({k: rng.standard_normal((B, s_sz, s_sz, 3)).astype(np.float32) for k in names[1]})
    xy, wh = rng.uniform(0.2, 0.5, (B, 2)), rng.uniform(0.15, 0.35, (B, 2))
    b["gt_xywh"] = np.concatenate([xy, wh], 1).astype(np.float32)
    if train_score:
        b["gt_xyxy"] = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        b["labels"] = np.array([1.0, 0.0], np.float32)
    return b


def _family_input(family):
    """A family's JAX model and variables, configs, batch, keep, and the
    port model on the same weights."""
    i = list(FAMILIES).index(family)
    script, recipe, train_score, keep = FAMILIES[family]
    jm, pm, rgbt, sizes = _models(family)
    variables = _variables(jm, rgbt, sizes, 11 + i)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return dict(jm=jm, variables=variables, model=pm, rgbt=rgbt, keep=keep,
                train_score=train_score,
                jcfg=_cfg(jax_default_config, script, recipe, train_score),
                cfg=_cfg(get_default_config, script, recipe, train_score),
                batch=_batch(rgbt, sizes, train_score, 21 + i))


def _jax_2x2_step(f):
    """The JAX package's step over a 2 x 2 mesh, the parameters and optimizer
    state sharded by param_shardings; its metrics."""
    jcfg = f["jcfg"]
    tx = jax_opt.make_optimizer(jcfg, f["variables"]["params"], steps_per_epoch=4)
    mesh = jax_mesh_2d(2, 2)
    state = jax_ts.TrainState.create(f["variables"], tx)
    shardings = param_shardings(state, mesh)
    state = jax.device_put(state, shardings)
    step = jax_ts.make_train_step(_Deterministic(f["jm"]), tx, mesh=mesh, rgbt=f["rgbt"],
                                  train_score=f["train_score"],
                                  score_weight=jcfg.TRAIN.get("SCORE_WEIGHT", 1.0),
                                  state_shardings=shardings)
    _, metrics = step(state, shard_batch(f["batch"], mesh), jax.random.PRNGKey(0),
                      ce_keep_rate=f["keep"])
    return {k: float(v) for k, v in metrics.items()}


def _one_process_step(f):
    """The port's step on the whole global batch in this process."""
    model = copy.deepcopy(f["model"])
    cfg = f["cfg"]
    opt = port_opt.make_optimizer(copy.deepcopy(cfg), model, steps_per_epoch=4)
    step = port_ts.make_train_step(model, opt, device="cpu", train_score=f["train_score"],
                                   score_weight=cfg.TRAIN.get("SCORE_WEIGHT", 1.0))
    m = step(f["batch"], ce_keep_rate=f["keep"])
    names = [n for n, _ in model.named_parameters()]
    return dict(metrics={k: float(v) for k, v in m.items()},
                params={k: p.detach().clone() for k, p in model.named_parameters()},
                buffers={k: b.clone() for k, b in model.state_dict().items() if k not in names},
                grads=dict(zip(names, opt.grads)))


#: the JAX work of the module, slowest first (its tracing takes 1 to 13 s a
#: job on a warm compile cache): each family's 2 x 2 step, each placement
#: recipe's shardings
JAX_JOBS = [("step", f) for f in FAMILIES] + [("dims", i) for i in range(11)]
#: the helper processes that share it, while the four ranks run
JAX_HELPERS = 4


def jax_jobs(jobs, path):
    """Run JAX jobs (`JAX_JOBS` entries) in this process and pickle
    {job: result} to `path`: a helper process of the `fam` fixture."""
    out = {}
    with jax.default_matmul_precision("highest"):
        for kind, what in jobs:
            if kind == "step":
                out[(kind, what)] = _jax_2x2_step(_family_input(what))
            else:
                script, cfg_script, recipe = PLACEMENT[what]
                out[(kind, what)] = _jax_dims(script, _placement_cfg(jax_default_config,
                                                                     cfg_script, recipe),
                                              (2, 3, 4))
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _start_jax_helpers(workdir):
    """JAX_HELPERS processes dealt JAX_JOBS in turn; (process, log, result
    path) each. They import this module after tests/conftest.py, so their
    JAX runs as the suite's does (CPU, 8 virtual devices, the compile
    cache)."""
    helpers = []
    for h in range(JAX_HELPERS):
        path, log = workdir / f"jax_{h}.pkl", open(workdir / f"jax_{h}.log", "w+b")
        code = ("import tests.conftest\n"
                "from tests.test_torch_port_tensor_parallel_families import JAX_JOBS, jax_jobs\n"
                f"jax_jobs(JAX_JOBS[{h}::{JAX_HELPERS}], {str(path)!r})\n")
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        helpers.append((subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                         stdout=log, stderr=subprocess.STDOUT), log, path))
    return helpers


def _finish_jax_helpers(helpers, timeout: float = 400.0) -> dict:
    """Wait for the helpers; their results merged. A helper that fails fails
    the caller, with its log."""
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p, _, _ in helpers:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p, _, _ in helpers:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log, path in helpers:
        log.seek(0)
        text = log.read().decode(errors="replace")
        assert p.returncode == 0, f"JAX helper exited {p.returncode}:\n{text[-6000:]}"
        with open(path, "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """A function that waits for the JAX helper processes (started when the
    module's first test asks for this fixture) and returns {job: result}."""
    helpers = _start_jax_helpers(tmp_path_factory.mktemp("tp_families_jax"))
    done = {}

    def results():
        if "out" not in done:
            done["out"] = _finish_jax_helpers(helpers)
        return done["out"]
    yield results
    for p, log, _ in helpers:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


@pytest.fixture(scope="module")
def fam(tmp_path_factory, jax_results):
    """The four ranks' results for every family and the one-process steps
    (the JAX helpers run meanwhile), and the JAX 2 x 2 steps' metrics."""
    workdir = tmp_path_factory.mktemp("tp_families")
    families = {k: _family_input(k) for k in FAMILIES}
    one = {k: _one_process_step(f) for k, f in families.items()}
    inp = {k: dict({n: f[n] for n in ("model", "cfg", "batch", "keep", "train_score")},
                   want={n: one[k][n] for n in ("grads", "params", "buffers")},
                   lr=_max_lr(f["cfg"]))
           for k, f in families.items()}
    torch.save(dict(families=inp), workdir / "inputs.pt")
    ranks = finish("tp_families", start("tp_families", workdir, WORLD), workdir, timeout=400.0)
    (workdir / "inputs.pt").unlink()           # some 400 MB of whole states
    return dict(ranks=ranks, families=families, one=one,
                jax={k: jax_results()[("step", k)] for k in FAMILIES})


def _max_lr(cfg) -> float:
    """The largest learning rate of the recipe's regime."""
    _, mults = port_opt._regime_labeler(cfg)
    return cfg.TRAIN.LR * max(1.0, *mults.values())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_step_matches_jax_2x2_step(fam, family):
    want = fam["jax"][family]
    for r in fam["ranks"]:
        got = r[family]["metrics"]
        assert got.keys() == want.keys()
        for k in want:
            if k == "grad_norm":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
            elif k == "Loss/total":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_step_matches_one_process_step(fam, family):
    """Each rank's metrics, and the gathered gradients, parameters and BN
    statistics it held against the one-process step (the worker compares
    them, `case_tp_families`)."""
    want = fam["one"][family]
    for r in fam["ranks"]:
        got = r[family]
        for k, w in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], w, atol=1e-6,
                                       rtol=1e-5 if k == "grad_norm" else 1e-6, err_msg=k)
        assert got["grad_keys"] == sorted(want["grads"])
        for k, err in got["grad_err"].items():
            assert err <= 1e-6, (k, err)
        for k, excess in got["param_excess"].items():
            assert excess <= 0, (k, excess)
        assert got["buffer_err"].keys() == want["buffers"].keys()
        for k, err in got["buffer_err"].items():
            assert err <= 1e-6, (k, err)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tp_ranks_hold_their_shards_and_equal_replicas(fam, family):
    ranks = [r[family] for r in fam["ranks"]]
    dims = ranks[0]["dims"]
    assert dims and all(r["dims"] == dims for r in ranks)
    for a, b in ((ranks[0], ranks[1]), (ranks[2], ranks[3])):
        for k, v in a["local_digests"].items():
            assert (v != b["local_digests"][k]) == (k in dims), k
    # the data ranks hold the same model after the step
    assert ranks[0]["param_digests"] == ranks[2]["param_digests"]
    if family.startswith(("online", "vit")) or family == "convmae":
        assert ranks[0]["heads"] == [h // 2 for h in ranks[0]["total_heads"]]
    assert (ranks[0]["row_parallel_convs"] > 0) == (family in CONV_FAMILIES)
    assert ranks[0]["running_stats"]          # the BN statistics are among them


@pytest.mark.parametrize("family", list(FAMILIES))
def test_shard_and_gather_state_dict_round_trip(fam, family):
    """The cut model's parameters are `shard_state_dict` of the whole ones,
    and `gather_state_dict` of them over the model group gives the whole
    ones back, bit for bit, on every rank."""
    for r in fam["ranks"]:
        assert r[family]["cut_is_shard"] and r[family]["gathered_equal"], r["grid"]


def test_row_parallel_conv_matches_conv2d(fam):
    """RowParallelConv2d over the model group of 2 against the whole conv2d,
    each case on every rank: CvT's `stage1` embedding (3x3, stride 2,
    padding 1) on the template's and the search's maps, ConvMAE's
    `patch_embed2` (2x2, stride 2); each difference over the largest
    magnitude of the whole conv's tensor."""
    cases = {c for r in fam["ranks"] for c in r["conv_check"]}
    assert cases == {"cvt_template", "cvt_search", "convmae_template"}
    for r in fam["ranks"]:
        for case, err in r["conv_check"].items():
            for k, e in err.items():
                assert e <= 1e-6, (r["grid"], case, k, e)


# ------------------------------------------------------------------ placement
#: one recipe of each of the 11 scripts beyond the flagship's: (script, the
#: script whose recipe it reads, recipe)
PLACEMENT = [("asymmetric_shared_online", "asymmetric_shared_online",
              "attention_lasher_newfusion_2layer"),
             ("mixformer_vit_rgbt", "mixformer_vit_rgbt", "attention_lasher_newfusion_2layer"),
             ("mixformer_vit_rgbt_online", "mixformer_vit_rgbt",
              "attention_lasher_newfusion_2layer"),
             ("mixformer_vit_rgbt_shared", "mixformer_vit_rgbt_shared",
              "attention_lasher_newfusion_2layer_lnspecific"),
             ("mixformer_vit_rgbt_unibackbone", "mixformer_vit_rgbt_unibackbone", "baseline"),
             ("mixformer_vit", "mixformer_vit", "baseline"),
             ("mixformer_vit_online", "mixformer_vit_online", "baseline"),
             ("mixformer_cvt", "mixformer_cvt", "baseline"),
             ("mixformer_cvt_online", "mixformer_cvt_online", "baseline"),
             ("mixformer_convmae", "mixformer_convmae", "baseline"),
             ("mixformer_convmae_online", "mixformer_convmae_online", "baseline")]
#: the recipes whose 16 heads do not split over 3 model ranks (ViT-L,
#: ConvMAE-L: qkv 3072 wide, proj 1024)
HEADS_DO_NOT_SPLIT = [("mixformer_vit", "baseline_large"),
                      ("mixformer_convmae", "baseline_large")]


def _fake_tp(n_model):
    """A TensorParallel of model rank 0 over groups that are never called
    (the checks before any collective, and a cut on the meta device)."""
    class Group:
        world, rank, backend, capturable, group = 1, 0, "gloo", False, None

    model = Group()
    model.world = n_model
    return port_mesh.TensorParallel(1, n_model, Group(), model)


def _port_meta(script, cfg):
    """The script's model at full width on the meta device (built with its
    weights uninitialised)."""
    with skip_default_init():
        if script in port_build._RGBT_SHARED:
            m = port_build.build_mixformer_rgbt(cfg, **port_build._RGBT_SHARED[script])
        elif script in port_build._UNIMODAL:
            m = port_build._UNIMODAL[script](cfg, with_score=script.endswith("_online"))
        else:
            m = port_build.build_vit_rgbt(cfg, **port_build._VIT_RGBT[script])
    return m.to("meta")


def _jax_dims(script, jcfg, n_models):
    """{n_model: {the port's key: the dimension `param_shardings` shards}}
    of the script's JAX model at full width (shapes only)."""
    jm = jax_build_model(script, jcfg)
    rgbt = script in port_build.RGBT_SCRIPTS
    n = 2 if rgbt else 1
    ts, ss = jcfg.DATA.TEMPLATE.SIZE, jcfg.DATA.SEARCH.SIZE
    t = jax.ShapeDtypeStruct((n, ts, ts, 3), jnp.float32)
    s = jax.ShapeDtypeStruct((n, ss, ss, 3), jnp.float32)
    score = script.endswith("_online")
    shapes = jax.eval_shape(lambda a, b, c: jm.init(jax.random.PRNGKey(0), a, b, c,
                                                    run_score_head=score), t, t, s)
    zeros = jax.tree.map(lambda x: np.broadcast_to(np.zeros((), np.float32), x.shape),
                         {"params": shapes["params"]})
    out = {}
    for n_model in n_models:
        specs = param_shardings(shapes["params"], jax_mesh_2d(2, n_model))
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
        out[n_model] = want
    return out


def _placement_cfg(get, cfg_script, recipe):
    c = get(cfg_script)
    c.update_from_file(os.path.join(ROOT, "experiments", cfg_script, f"{recipe}.yaml"))
    return c


@pytest.mark.parametrize("case", range(len(PLACEMENT)),
                         ids=[f"{s}-{r}" for s, _, r in PLACEMENT])
def test_tp_dims_match_jax_param_shardings_at_full_width(jax_results, case):
    script, cfg_script, recipe = PLACEMENT[case]
    jax_dims = jax_results()[("dims", case)]
    whole = _port_meta(script, _placement_cfg(get_default_config, cfg_script, recipe))
    for n_model, want in jax_dims.items():
        model = copy.deepcopy(whole)
        got = port_mesh.tensor_parallel_dims(model, n_model)
        assert got == want, (n_model, sorted(set(got) ^ set(want))[:8])
        assert set(got.values()) <= {0, 1}
        convs = [k for k in got if model.get_parameter(k).dim() == 4]
        port_tp.shard_tensor_parallel_(model, _fake_tp(n_model))
        assert model.tp_dims == got
        for k in convs:
            mod = model.get_submodule(k.rsplit(".", 1)[0])
            assert isinstance(mod, port_tp.RowParallelConv2d), k
        if "convmae" in script:
            # ConvMAE's conv FFN (flax mlp_fc1 / mlp_fc2) stays whole
            assert not any(".mlp." in k for k in got if k.startswith("backbone.blocks1"))
            if n_model in (2, 4):
                assert {"backbone.patch_embed2.proj.weight",
                        "backbone.patch_embed3.proj.weight"} <= set(convs)
        if "cvt" in script and n_model in (2, 4):
            assert {"backbone.stage1.patch_embed.proj.weight",
                    "backbone.stage2.patch_embed.proj.weight"} <= set(convs)
            assert isinstance(model.backbone.stage2.blocks[0].attn.proj,
                              port_tp.RowParallelLinear)
            assert model.backbone.stage2.blocks[0].attn.proj.scatter_input



@pytest.mark.parametrize("script,recipe", HEADS_DO_NOT_SPLIT)
def test_tp_raises_where_heads_do_not_split(script, recipe):
    """ViT-L's and ConvMAE-L's 16 heads over 3 model ranks: the rule cuts
    qkv (3072 rows) and not proj (1024 input columns), and the cut raises
    ValueError; over 2 and 4 ranks it cuts."""
    cfg = get_default_config(script)
    cfg.update_from_file(os.path.join(ROOT, "experiments", script, f"{recipe}.yaml"))
    whole = _port_meta(script, cfg)
    for n_model in (2, 3, 4):
        model = copy.deepcopy(whole)
        if n_model == 3:
            with pytest.raises(ValueError, match="16 heads cannot be split over 3"):
                port_tp.shard_tensor_parallel_(model, _fake_tp(n_model))
        else:
            dims = port_tp.shard_tensor_parallel_(model, _fake_tp(n_model))
            heads = {m.num_heads for m in model.modules() if hasattr(m, "set_model_group")}
            assert dims and heads == {16 // n_model}
