"""Default config trees of every script: the `asymmetric_shared*`
flagship family, the `mixformer_vit_rgbt*` family and the unimodal
`mixformer_vit*`, `mixformer_cvt*` and `mixformer_convmae*`.

The port's own copy of the JAX package's `config/defaults.py`
(`_rgbt_base`, `_with_ce`, `_with_score`, `_unimodal_vit`, `_cvt`): the
same default trees, so the same `experiments/*.yaml` recipes overlay onto
them. `mixformer_vit_rgbt_online` has no default tree there, nor here: its
model builds from a config the caller passes (`models.build.build_model`).
"""
from __future__ import annotations

from multi_modal_tracking_torch.config.node import CfgNode


def _rgbt_base() -> CfgNode:
    """Shared RGB-T default tree."""
    c = CfgNode()
    c.MODEL = CfgNode(dict(
        RGBT_PRETRAINED_PATH="",
        VIT_TYPE="base_patch16",
        HEAD_TYPE="CORNER",
        HIDDEN_DIM=768,
        NUM_OBJECT_QUERIES=1,
        POSITION_EMBEDDING="sine",
        PREDICT_MASK=False,
        HEAD_DIM=384,
        HEAD_FREEZE_BN=False,
        BACKBONE=dict(PRETRAINED=True, PRETRAINED_PATH=""),
        FUSION_LAYERS=6,
        FUSION_CLASS="Attention_Fusion_Bimodal",
    ))
    c.TRAIN = CfgNode(dict(
        RGBT_TRACK=False,
        RGBT_TRACK_SHARED=True,
        AMP=False,
        ACCUM_ITER=1,
        FREEZE_FIRST_6LAYERS=False,
        LR=0.0001,
        WEIGHT_DECAY=0.0001,
        EPOCH=300,
        WARMUP_EPOCHS=40,
        MIN_LR=0.0,
        LR_DROP_EPOCH=400,
        BATCH_SIZE=16,
        NUM_WORKER=8,
        OPTIMIZER="ADAMW",
        BACKBONE_MULTIPLIER=0.1,
        IOU_WEIGHT=2.0,
        L1_WEIGHT=5.0,
        DEEP_SUPERVISION=False,
        FREEZE_STAGE0=False,
        PRINT_INTERVAL=50,
        VAL_EPOCH_INTERVAL=20,
        GRAD_CLIP_NORM=0.1,
        SCHEDULER=dict(TYPE="step", DECAY_RATE=0.1),
        FSDP=False,
        REMAT=False,
    ))
    c.DATA = CfgNode(dict(
        SAMPLER_MODE="causal",
        MEAN=[0.485, 0.456, 0.406],
        STD=[0.229, 0.224, 0.225],
        MAX_SAMPLE_INTERVAL=[200],
        TRAIN=dict(DATASETS_NAME=["GOT10K_vottrain"], DATASETS_RATIO=[1], SAMPLE_PER_EPOCH=60000),
        VAL=dict(DATASETS_NAME=["GOT10K_votval"], DATASETS_RATIO=[1], SAMPLE_PER_EPOCH=10000),
        SEARCH=dict(SIZE=288, FACTOR=5.0, CENTER_JITTER=4.5, SCALE_JITTER=0.5),
        TEMPLATE=dict(SIZE=128, FACTOR=2.0, NUMBER=1, CENTER_JITTER=0, SCALE_JITTER=0),
    ))
    c.TEST = CfgNode(dict(
        LOAD_FROME_TRAIN_RESULT=False,
        TEMPLATE_FACTOR=2.0,
        TEMPLATE_SIZE=128,
        SEARCH_FACTOR=5.0,
        SEARCH_SIZE=288,
        EPOCH=500,
        SEARCH_CENTER_JITTER=0.0,
        SEARCH_SCALE_JITTER=0.0,
        TEMPLATE_CENTER_JITTER=0.0,
        TEMPLATE_SCALE_JITTER=0.0,
        # RGB-T benchmarks have no entry: they fall back to
        # DATA.MAX_SAMPLE_INTERVAL (eval/params.py update_interval_for)
        UPDATE_INTERVALS=dict(LASOT=[200], GOT10K_TEST=[200], TRACKINGNET=[200],
                              VOT20=[200], VOT20LT=[200]),
    ))
    return c


def _with_ce(c: CfgNode) -> CfgNode:
    c.MODEL.BACKBONE.STRIDE = 16
    c.MODEL.BACKBONE.CE_LOC = [3, 6, 9]
    c.MODEL.BACKBONE.CE_KEEP_RATIO = [0.7, 0.7, 0.7]
    c.MODEL.BACKBONE.CE_TEMPLATE_RANGE = "CTR_POINT"
    c.TRAIN.CE_START_EPOCH = 20
    c.TRAIN.CE_WARM_EPOCH = 80
    return c


def _with_score(c: CfgNode) -> CfgNode:
    c.MODEL.TRACKER_PRETRAINED_PATH = ""
    c.MODEL.SCORE_PRETRAINED_PATH = ""
    c.MODEL.NLAYER_HEAD = 3
    c.TRAIN.TRAIN_SCORE = False
    c.TRAIN.SCORE_WEIGHT = 1.0
    c.TEST.ONLINE_SIZES = CfgNode(dict(LASOT=[3], GOT10K_TEST=[3], TRACKINGNET=[3],
                                       VOT20=[3], VOT20LT=[3], OTB=[3], UAV=[3]))
    for k in ("OTB", "UAV"):
        c.TEST.UPDATE_INTERVALS[k] = [200]
    return c


def _unimodal_vit() -> CfgNode:
    c = _rgbt_base()
    del c.MODEL["RGBT_PRETRAINED_PATH"], c.MODEL["FUSION_LAYERS"], c.MODEL["FUSION_CLASS"]
    del c.TRAIN["RGBT_TRACK"], c.TRAIN["RGBT_TRACK_SHARED"]
    c.MODEL.RGB_PRETRAINED_PATH = ""
    c.DATA.MAX_SAMPLE_INTERVAL = 200
    return c


def _cvt(online: bool) -> CfgNode:
    """The CvT scripts' tree (the JAX package's config/defaults.py:123-162):
    the base script ships CvT-13 depths [1, 2, 10], the online one CvT-21
    [1, 4, 16], both at search 320; the online one trains stage 2
    (TRAIN_SCORE) with the trident_pro sampler by default."""
    c = _unimodal_vit()
    c.MODEL.VIT_TYPE = "cvt_21"
    c.MODEL.HIDDEN_DIM = 384
    c.MODEL.BACKBONE.update(dict(
        INIT="trunc_norm", NUM_STAGES=3,
        PATCH_SIZE=[7, 3, 3], PATCH_STRIDE=[4, 2, 2], PATCH_PADDING=[2, 1, 1],
        DIM_EMBED=[64, 192, 384], NUM_HEADS=[1, 3, 6],
        DEPTH=[1, 4, 16] if online else [1, 2, 10],
        MLP_RATIO=[4.0, 4.0, 4.0], ATTN_DROP_RATE=[0.0, 0.0, 0.0],
        DROP_RATE=[0.0, 0.0, 0.0], DROP_PATH_RATE=[0.0, 0.0, 0.1],
        QKV_BIAS=[True, True, True], CLS_TOKEN=[False, False, True],
        POS_EMBED=[False, False, False],
        QKV_PROJ_METHOD=["dw_bn", "dw_bn", "dw_bn"], KERNEL_QKV=[3, 3, 3],
        PADDING_KV=[1, 1, 1], STRIDE_KV=[2, 2, 2], PADDING_Q=[1, 1, 1],
        STRIDE_Q=[1, 1, 1], FREEZE_BN=True,
    ))
    c.MODEL.PRETRAINED_STAGE1 = True
    c.TRAIN.EPOCH = 500
    c.DATA.SEARCH.SIZE = 320
    c.TEST.SEARCH_SIZE = 320
    if online:
        _with_score(c)
        c.TRAIN.HINGE_WEIGHT = 100
        c.TRAIN.TRAIN_SCORE = True
        c.DATA.SAMPLER_MODE = "trident_pro"
    return c


def _online_unimodal(c: CfgNode) -> CfgNode:
    """The score branch's keys of the unimodal online scripts."""
    c.MODEL.PRETRAINED_STAGE1 = False
    _with_score(c)
    c.TRAIN.HINGE_WEIGHT = 100
    c.TRAIN.EPOCH = 500
    return c


def get_default_config(script: str) -> CfgNode:
    if script in ("asymmetric_shared", "mixformer_vit_rgbt", "mixformer_vit_rgbt_shared",
                  "mixformer_vit_rgbt_unibackbone"):
        c = _rgbt_base()
        if script == "mixformer_vit_rgbt":
            c.TRAIN.RGBT_TRACK = True
        if script == "mixformer_vit_rgbt_unibackbone":
            c.TRAIN.RGBT_TRACK_UNIBACKBONE = True
        return c
    if script == "asymmetric_shared_ce":
        return _with_ce(_rgbt_base())
    if script == "asymmetric_shared_online":
        c = _rgbt_base()
        del c.MODEL["RGBT_PRETRAINED_PATH"]
        return _with_score(c)
    if script == "mixformer_vit":
        c = _unimodal_vit()
        # a key the reference keeps in this script's defaults, so that the
        # recipes overlay strictly
        c.MODEL.FUSION_LAYERS = 6
        return c
    if script == "mixformer_vit_online":
        return _online_unimodal(_unimodal_vit())
    if script in ("mixformer_cvt", "mixformer_cvt_online"):
        return _cvt(online=script.endswith("online"))
    if script in ("mixformer_convmae", "mixformer_convmae_online"):
        c = _unimodal_vit()
        c.MODEL.VIT_TYPE = "convmae_base"
        return _online_unimodal(c) if script.endswith("online") else c
    raise KeyError(f"unknown script {script}")
