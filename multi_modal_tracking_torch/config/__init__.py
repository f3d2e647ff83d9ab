from multi_modal_tracking_torch.config.node import CfgNode
from multi_modal_tracking_torch.config.defaults import get_default_config

__all__ = ["CfgNode", "get_default_config"]
