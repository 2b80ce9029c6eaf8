from .manager import CheckpointManager, TensorSpec
