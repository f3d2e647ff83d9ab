"""Dataset registry and the train and val loaders.

The port's counterpart of the JAX package's `train/builders.py`. The
registry knows every name the JAX package knows; the synthetic sets are
ported (`SyntheticRGBT`, and the unimodal `SyntheticVideo`), and every
other name raises NotImplementedError (the real dataset adapters need
image files and a decoder: ROADMAP.md queue 1 item 1). A config whose
training sets are RGB-T (`is_rgbt_config`) gets `RGBTProcessing` and the
sampler's RGB-T frames; any other, `UnimodalProcessing`.
The sample budget and the batch are divided by the torch world size (1
without `torch.distributed`), as each rank loads its own share.
"""
from __future__ import annotations

import random
from typing import List, Optional, Tuple

import torch

from multi_modal_tracking_torch.train.data.loader import Loader
from multi_modal_tracking_torch.train.data.processing import RGBTProcessing, UnimodalProcessing
from multi_modal_tracking_torch.train.data.sampler import TrackingSampler

RGBT_NAMES = {"VTUAV", "LasHeR", "RGBT234", "KAIST", "LLVIP", "M3FD",
              "DepthTrack", "DepthTrack-Train", "DepthTrack-Test",
              "DepthTrack_Train", "DepthTrack_Test",
              "VTUAV_Test", "VTUAV-Test", "SyntheticRGBT", "SyntheticRGBTHard",
              "SyntheticRGBTHardVisible"}
#: names the JAX package's registry builds that the port does not yet
_NOT_PORTED = RGBT_NAMES - {"SyntheticRGBT"} | {
    "LasHeR_T", "RGBT234_T", "LASOT", "GOT10K_vottrain", "GOT10K_votval",
    "GOT10K_train_full", "TRACKINGNET", "COCO17", "VID", "TNL2k",
    "LASOT_lmdb", "GOT10K_vottrain_lmdb", "GOT10K_votval_lmdb", "GOT10K_train_full_lmdb",
    "TRACKINGNET_lmdb", "COCO17_lmdb", "VID_lmdb"}


def names2datasets(names: List[str]):
    """Instantiate dataset adapters by registry name."""
    from multi_modal_tracking_torch.train.data.datasets import SyntheticRGBT, SyntheticVideo
    out = []
    for n in names:
        if n == "SyntheticRGBT":
            out.append(SyntheticRGBT())
        elif n == "SyntheticVideo":
            out.append(SyntheticVideo())
        elif n in _NOT_PORTED:
            raise NotImplementedError(f"dataset {n!r} is not ported to multi_modal_tracking_torch "
                                      f"yet (ROADMAP.md queue 1 item 1: the real dataset "
                                      f"adapters); SyntheticRGBT and SyntheticVideo are")
        else:
            raise ValueError(f"Unknown dataset name {n}")
    return out


def is_rgbt_config(cfg) -> bool:
    return any(n in RGBT_NAMES for n in cfg.DATA.TRAIN.DATASETS_NAME)


def world_size() -> int:
    return torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1


def _make_loader(cfg, split_cfg, name: str, train: bool, seed: int) -> Loader:
    """TrackingSampler + RGBTProcessing or UnimodalProcessing + Loader of
    one split, this rank's share of the budget and the batch. The val
    split is seeded with seed + 1, processes without training augmentation
    and runs every VAL_EPOCH_INTERVAL epochs."""
    seed = seed if train else seed + 1
    rgbt = is_rgbt_config(cfg)
    processing = (RGBTProcessing if rgbt else UnimodalProcessing)(
        search_area_factor={"template": cfg.DATA.TEMPLATE.FACTOR, "search": cfg.DATA.SEARCH.FACTOR},
        output_sz={"template": cfg.DATA.TEMPLATE.SIZE, "search": cfg.DATA.SEARCH.SIZE},
        center_jitter_factor={"template": cfg.DATA.TEMPLATE.CENTER_JITTER,
                              "search": cfg.DATA.SEARCH.CENTER_JITTER},
        scale_jitter_factor={"template": cfg.DATA.TEMPLATE.SCALE_JITTER,
                             "search": cfg.DATA.SEARCH.SCALE_JITTER},
        rng=random.Random(seed), train=train)
    sampler = TrackingSampler(
        datasets=names2datasets(split_cfg.DATASETS_NAME),
        p_datasets=split_cfg.DATASETS_RATIO,
        samples_per_epoch=max(1, split_cfg.SAMPLE_PER_EPOCH // world_size()),
        max_gap=cfg.DATA.MAX_SAMPLE_INTERVAL,
        num_search_frames=1,
        num_template_frames=cfg.DATA.TEMPLATE.get("NUMBER", 1),
        processing=processing,
        frame_sample_mode=cfg.DATA.SAMPLER_MODE,
        train_cls=cfg.TRAIN.get("TRAIN_SCORE", False),
        rgbt=rgbt,
        seed=seed)
    return Loader(sampler, batch_size=max(1, cfg.TRAIN.BATCH_SIZE // world_size()),
                  num_workers=cfg.TRAIN.NUM_WORKER, name=name, training=train,
                  epoch_interval=1 if train else cfg.TRAIN.VAL_EPOCH_INTERVAL)


def build_train_loader(cfg, seed: int = 0) -> Loader:
    """The training loader of a config, seeded."""
    return _make_loader(cfg, cfg.DATA.TRAIN, "train", True, seed)


def build_dataloaders(cfg, seed: int = 0) -> Tuple[Loader, Optional[Loader]]:
    """(train_loader, val_loader | None). A val split that cannot be built
    (a dataset that is not ported, or not on this machine) disables
    validation with a printed line; an unknown dataset name still raises
    ValueError."""
    train_loader = build_train_loader(cfg, seed)
    val_loader = None
    if cfg.DATA.get("VAL") and cfg.DATA.VAL.DATASETS_NAME:
        try:
            val_loader = _make_loader(cfg, cfg.DATA.VAL, "val", False, seed)
        except ValueError:
            raise
        except Exception as e:
            print(f"[build_dataloaders] val loader disabled: {e!r}")
    return train_loader, val_loader
