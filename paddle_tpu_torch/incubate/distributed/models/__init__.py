"""paddle_tpu_torch.incubate.distributed.models: ``moe``."""
from . import moe
from .moe import GShardGate, MoELayer, NaiveGate, SwitchGate

__all__ = ["moe", "MoELayer", "GShardGate", "SwitchGate", "NaiveGate"]
