from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .schedule import wsd_schedule  # noqa: F401
