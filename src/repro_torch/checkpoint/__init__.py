from .manager import CheckpointManager, flatten_state  # noqa: F401
