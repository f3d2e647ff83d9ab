"""Dataset registry and the train and val loaders.

The port's counterpart of the JAX package's `train/builders.py`. The
registry builds every name the JAX package builds: the file-based RGB-T
and unimodal adapters (their frames decoded by the port's own decoder),
their LMDB twins (which need the `lmdb` package when they read), and the
synthetic sets. A config whose training sets are RGB-T (`is_rgbt_config`)
gets `RGBTProcessing` and the sampler's RGB-T frames; any other,
`UnimodalProcessing`.
Data parallel (the JAX package's train/builders.py:108-136):
SAMPLE_PER_EPOCH and TRAIN.BATCH_SIZE are the GLOBAL budget and batch;
each rank's loader draws SAMPLE_PER_EPOCH // world samples in batches of
BATCH_SIZE // world (world: the torch process group's size, 1 without
one), from a sampler the Trainer seeds with seed + rank
(`parallel.distributed.process_seed`). A batch that the world size does
not divide raises.
"""
from __future__ import annotations

import random
from typing import List, Optional, Tuple

from multi_modal_tracking_torch.parallel.distributed import world_size
from multi_modal_tracking_torch.train.data.loader import Loader
from multi_modal_tracking_torch.train.data.processing import RGBTProcessing, UnimodalProcessing
from multi_modal_tracking_torch.train.data.sampler import TrackingSampler

RGBT_NAMES = {"VTUAV", "LasHeR", "RGBT234", "KAIST", "LLVIP", "M3FD",
              "DepthTrack", "DepthTrack-Train", "DepthTrack-Test",
              "DepthTrack_Train", "DepthTrack_Test",
              "VTUAV_Test", "VTUAV-Test", "SyntheticRGBT", "SyntheticRGBTHard",
              "SyntheticRGBTHardVisible"}


def names2datasets(names: List[str], image_loader=None):
    """Instantiate dataset adapters by registry name (`image_loader`
    replaces the file adapters' `opencv_loader`)."""
    from multi_modal_tracking_torch.train.data.datasets import (SyntheticRGBT, SyntheticRGBTHard,
                                                                SyntheticVideo)
    from multi_modal_tracking_torch.train.data.datasets import lmdb_twins as L
    from multi_modal_tracking_torch.train.data.datasets import rgbt as R
    from multi_modal_tracking_torch.train.data.datasets import unimodal as U
    kw = {} if image_loader is None else {"image_loader": image_loader}
    table = {
        "LasHeR": lambda: R.LasHeR(**kw),
        "RGBT234": lambda: R.RGBT234(**kw),
        "VTUAV": lambda: R.VTUAV(**kw),
        "VTUAV_Test": lambda: R.VTUAV(split_dirs=("test_data",), **kw),
        "DepthTrack": lambda: R.DepthTrack(**kw),
        # the reference registry's spellings and their underscore twins
        "DepthTrack-Train": lambda: R.DepthTrack(split="train", **kw),
        "DepthTrack-Test": lambda: R.DepthTrack(split="test", **kw),
        "DepthTrack_Train": lambda: R.DepthTrack(split="train", **kw),
        "DepthTrack_Test": lambda: R.DepthTrack(split="test", **kw),
        "VTUAV-Test": lambda: R.VTUAV(split_dirs=("test_data",), **kw),
        "KAIST": lambda: R.KAIST(**kw),
        "LLVIP": lambda: R.LLVIP(**kw),
        "M3FD": lambda: R.M3FD(**kw),
        "LasHeR_T": lambda: R.LasHeR_TIR(**kw),
        "RGBT234_T": lambda: R.RGBT234_TIR(**kw),
        "LASOT": lambda: U.LaSOT(**kw),
        "GOT10K_vottrain": lambda: U.GOT10k(split="vottrain", **kw),
        "GOT10K_votval": lambda: U.GOT10k(split="votval", **kw),
        "GOT10K_train_full": lambda: U.GOT10k(split="train_full", **kw),
        "TRACKINGNET": lambda: U.TrackingNet(**kw),
        "COCO17": lambda: U.COCOSeq(**kw),
        "VID": lambda: U.ImagenetVID(**kw),
        "TNL2k": lambda: U.TNL2k(**kw),
        "SyntheticRGBT": lambda: SyntheticRGBT(),
        "SyntheticRGBTHard": lambda: SyntheticRGBTHard(),
        # more appearance diversity and occluded frames, but no absence
        # stretches (a search on a frame without the target would supervise
        # the box head on no target pixels)
        "SyntheticRGBTHardVisible": lambda: SyntheticRGBTHard(n_sequences=24, absent_every=0),
        "SyntheticVideo": lambda: SyntheticVideo(),
        # the LMDB twins, addressed by suffixed name
        "LASOT_lmdb": lambda: L.LaSOTLmdb(),
        "GOT10K_vottrain_lmdb": lambda: L.GOT10kLmdb(split="vottrain"),
        "GOT10K_votval_lmdb": lambda: L.GOT10kLmdb(split="votval"),
        "GOT10K_train_full_lmdb": lambda: L.GOT10kLmdb(split="train_full"),
        "TRACKINGNET_lmdb": lambda: L.TrackingNetLmdb(),
        "COCO17_lmdb": lambda: L.COCOSeqLmdb(),
        "VID_lmdb": lambda: L.ImagenetVIDLmdb(),
    }
    out = []
    for n in names:
        if n not in table:
            raise ValueError(f"Unknown dataset name {n}")
        out.append(table[n]())
    return out


def is_rgbt_config(cfg) -> bool:
    return any(n in RGBT_NAMES for n in cfg.DATA.TRAIN.DATASETS_NAME)


def local_batch_size(cfg) -> int:
    """This rank's share of TRAIN.BATCH_SIZE; raises ValueError if the world
    size does not divide it (every batch would be short)."""
    world = world_size()
    if cfg.TRAIN.BATCH_SIZE % world:
        raise ValueError(f"TRAIN.BATCH_SIZE {cfg.TRAIN.BATCH_SIZE} (the global batch) is not "
                         f"divisible by the {world} processes: pick a multiple of {world}")
    return max(1, cfg.TRAIN.BATCH_SIZE // world)


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
    return Loader(sampler, batch_size=local_batch_size(cfg),
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
