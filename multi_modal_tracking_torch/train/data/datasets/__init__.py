from multi_modal_tracking_torch.train.data.datasets.base import (BaseImageDataset,
                                                                BaseVideoDataset)
from multi_modal_tracking_torch.train.data.datasets.lmdb_twins import (COCOSeqLmdb, GOT10kLmdb,
                                                                      ImagenetVIDLmdb, LaSOTLmdb,
                                                                      TrackingNetLmdb)
from multi_modal_tracking_torch.train.data.datasets.synthetic import (SyntheticRGBT,
                                                                     SyntheticRGBTHard,
                                                                     SyntheticVideo)
